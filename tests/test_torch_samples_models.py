"""The port's model and device-pipeline samples
(videoprocessingframework_torch/samples: sample_resnet, sample_segmentation,
sample_serving, sample_batch_inference, sample_decode_multi_thread,
sample_aot_compile, sample_device_transcode, sample_dataloader,
sample_train_video) on the CPU.

Each test of tests/test_samples.py for these samples has a counterpart
here that runs the port's sample with ``--device cpu`` and the same
arguments, in a subprocess, and asserts the same printed line.

The slice as a whole: the JAX sample's ``forward``
(samples/sample_jax_resnet.py:37-47: NV12 ``decode_postproc`` →
ResNet-50, here float32 with seeded variables) against
``sample_resnet.run`` with the variables carried across by
``from_jax_variables``, on the first 8 frames of tests/assets/test.mp4;
the same for sample_segmentation's FCN masks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_samples_io import run_sample
from videoprocessingframework_tpu import compat as jnvc
from videoprocessingframework_tpu.models import resnet as jresnet
from videoprocessingframework_tpu.models import segmentation as jseg
from videoprocessingframework_tpu.ops import fused as jfused
from videoprocessingframework_torch import models as tm
from videoprocessingframework_torch.core.enums import (
    ColorRange,
    ColorSpace,
    PixelFormat,
)
from videoprocessingframework_torch.io.decoder import VideoReader
from videoprocessingframework_torch.samples import (
    sample_aot_compile,
    sample_device_transcode,
    sample_resnet,
    sample_segmentation,
)
from videoprocessingframework_torch.samples._utils import nv12_batches

CPU = torch.device("cpu")
#: logits, JAX forward vs the port's run: both float32; the JAX resize
#: is split-bf16 and the port's full float32, which moves a normalized
#: input by float32 rounding noise only (|logit| is at most ~15 here)
LOGIT_ATOL = 1e-3
#: FCN masks: share of pixels whose argmax may differ (near-ties of the
#: 21 class logits under that same noise)
MASK_SHARE = 1e-4


# ---- the printed lines (tests/test_samples.py) ------------------------------


def test_sample_resnet(test_mp4):
    out = run_sample("sample_resnet", test_mp4, "--frames", "4", "--batch",
                     "2")
    assert "classified 4 frames" in out


def test_sample_segmentation(test_mp4):
    out = run_sample("sample_segmentation", test_mp4, "--frames", "2")
    assert "segmented 2 frames" in out


def test_sample_batch_inference(test_mp4):
    out = run_sample("sample_batch_inference", test_mp4, "--streams", "1",
                     "--batch", "4")
    assert "classified" in out


def test_sample_decode_multi_thread(test_mp4):
    out = run_sample("sample_decode_multi_thread", test_mp4, "--streams",
                     "2")
    assert "aggregate fps" in out


def test_sample_aot_compile(test_mp4, tmp_path):
    out = run_sample("sample_aot_compile", test_mp4, "--batch", "4",
                     "--engine", str(tmp_path / "engine.pt2"))
    assert "engine compiled" in out
    assert "served" in out


def test_sample_device_transcode(test_mp4, tmp_path):
    out = run_sample("sample_device_transcode", test_mp4,
                     str(tmp_path / "d.h264"), "--size", "424x232",
                     "--frames", "24")
    assert "device-transcoded 24 frames" in out


def test_sample_dataloader(test_mp4):
    out = run_sample("sample_dataloader", test_mp4, "--clip-len", "4",
                     "--batch", "2", "--size", "64", "--workers", "1")
    assert "clips/epoch" in out
    assert "epoch 0:" in out


def test_sample_dataloader_mjpeg():
    out = run_sample("sample_dataloader", "--mjpeg", "--clip-len", "2",
                     "--batch", "2", "--size", "48", "--workers", "1")
    assert "synthesized MJPEG corpus" in out
    assert "epoch 0:" in out


def test_sample_train_video(test_mp4):
    out = run_sample("sample_train_video", test_mp4, "--clip-len", "2",
                     "--batch", "2", "--size", "32", "--steps", "2")
    assert "trained 2 steps" in out
    assert "final loss" in out


def test_sample_train_video_checkpoint_resume(test_mp4, tmp_path):
    ck = str(tmp_path / "ck")
    run_sample("sample_train_video", test_mp4, "--clip-len", "2",
               "--batch", "2", "--size", "32", "--steps", "2",
               "--checkpoint", ck, "--save-every", "1")
    out = run_sample("sample_train_video", test_mp4, "--clip-len", "2",
                     "--batch", "2", "--size", "32", "--steps", "3",
                     "--checkpoint", ck, "--save-every", "1")
    assert "resumed at step 2" in out
    assert "trained 3 steps" in out


def test_sample_serving(test_mp4):
    out = run_sample("sample_serving", test_mp4, "--clients", "2",
                     "--frames", "8", "--max-batch", "4")
    assert "served 8 requests" in out
    assert "p50" in out


def test_samples_raise_without_a_gpu(test_mp4):
    """No --device: CUDA, which raises without a GPU rather than running
    on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the sample would run on it")
    out = run_sample("sample_resnet", test_mp4, "--frames", "1",
                     device=None, ok=False)
    assert "no CUDA device is available" in out


# ---- the slice vs the JAX sample --------------------------------------------


def _seeded_variables(model, seed=0):
    """Every leaf from a numpy generator (Flax's init zeroes each bn3
    scale, which would leave the residual branches dead)."""
    variables = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)), False))
    r = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name in ("var", "scale"):
            a = r.uniform(0.5, 1.5, leaf.shape)
        elif name == "kernel":
            a = r.standard_normal(leaf.shape) / np.sqrt(
                np.prod(leaf.shape[:-1]))
        else:
            a = 0.1 * r.standard_normal(leaf.shape)
        return a.astype(leaf.dtype)

    return jax.tree_util.tree_map_with_path(fill, jax.device_get(variables))


def _jax_forward(jmodel, src):
    """samples/sample_jax_resnet.py:37-47, rebuilt from the JAX package."""
    dmx = jnvc.PyFFmpegDemuxer(src)

    @jax.jit
    def forward(vars_, y, uv):
        x = jfused.decode_postproc(
            y, uv,
            src_format=jnvc.PixelFormat.NV12,
            space=dmx.ColorSpace(),
            rng=dmx.ColorRange(),
            out_h=224, out_w=224,
            output="normalized",
        )
        return jmodel.apply(vars_, x, train=False)

    return forward


def _first_frames(src, n=8):
    y, uv = next(nv12_batches(src, n, n, "cpu"))
    assert y.shape == (n, 464, 848) and uv.shape == (n, 232, 848)
    return y, uv


def test_sample_resnet_matches_jax_sample(test_mp4):
    y, uv = _first_frames(test_mp4)
    jm = jresnet.resnet50(dtype=jnp.float32)
    variables = _seeded_variables(jm)
    want = np.asarray(_jax_forward(jm, test_mp4)(variables, y, uv))

    model = tm.resnet50(dtype=torch.float32)
    model.load_state_dict(tm.from_jax_variables(variables))
    dmx = jnvc.PyFFmpegDemuxer(test_mp4)
    got = sample_resnet.run(
        [(y[:5], uv[:5]), (y[5:], uv[5:])], model.eval(),
        space=ColorSpace(int(dmx.ColorSpace())),
        rng=ColorRange(int(dmx.ColorRange())), device=CPU).numpy()
    assert got.shape == want.shape == (8, 1000)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=LOGIT_ATOL)


def test_sample_segmentation_matches_jax_sample(test_mp4):
    y, uv = _first_frames(test_mp4, 4)
    jm = jseg.FCNResNet(dtype=jnp.float32)
    variables = _seeded_variables(jm, seed=1)
    forward = _jax_forward(jm, test_mp4)
    want = np.concatenate([
        np.asarray(forward(variables, y[i:i + 1], uv[i:i + 1])).argmax(-1)
        for i in range(len(y))])

    model = tm.fcn_resnet(dtype=torch.float32)
    model.load_state_dict(tm.from_jax_variables(variables))
    dmx = jnvc.PyFFmpegDemuxer(test_mp4)
    masks = sample_segmentation.run(
        [(y[i:i + 1], uv[i:i + 1]) for i in range(len(y))], model.eval(),
        space=ColorSpace(int(dmx.ColorSpace())),
        rng=ColorRange(int(dmx.ColorRange())), device=CPU)
    got = torch.cat(masks).numpy()
    assert got.shape == want.shape == (4, 224, 224)
    assert (got != want).mean() <= MASK_SHARE


# ---- the device stages vs the JAX package -----------------------------------


def _yuv420_batches(src, n, batch):
    reader = VideoReader(src)
    reader.decoder.output_format = PixelFormat.YUV420
    h, w = reader.height(), reader.width()
    frames = []
    for f in reader.frames():
        frames.append(f.data.reshape(h * 3 // 2, w).copy())
        if len(frames) == n:
            break
    packed = np.stack(frames)
    return [packed[i:i + batch] for i in range(0, n, batch)], reader


def test_sample_device_transcode_matches_jax(test_mp4):
    """The encoder's input frames, the port's run vs the JAX sample's
    device chain (FusedPipeline rgb_f32 1:1 → band × 0.5 → encode_feed →
    planes_to_host_packed) on the same decoded YUV420 frames: within 1
    code."""
    batches, reader = _yuv420_batches(test_mp4, 8, 4)
    w, h = reader.width(), reader.height()
    space, rng = reader.color_space(), reader.color_range()
    jto_rgb = jfused.FusedPipeline(int(PixelFormat.YUV420), int(space),
                                   int(rng), out_size=(w, h),
                                   output="rgb_f32")
    want = []
    for b in batches:
        rgb = jto_rgb(b)
        rgb = rgb.at[:, h // 3: h // 2].multiply(0.5)
        planes = jfused.encode_feed(jnp.clip(rgb, 0.0, 1.0), out_h=232,
                                    out_w=424, space=int(space),
                                    rng=int(rng))
        want.append(np.asarray(jfused.planes_to_host_packed(*planes)))

    to_rgb = sample_device_transcode.to_rgb(w, h, space, rng, CPU)
    got = list(sample_device_transcode.run(
        (to_rgb(b) for b in batches), out_w=424, out_h=232, space=space,
        rng=rng))
    got, want = np.concatenate(got), np.concatenate(want)
    assert got.shape == want.shape == (8, 232 * 3 // 2, 424)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_sample_aot_engine_round_trip(tmp_path):
    """The reloaded program equals the eager serve module, and a wrong
    batch raises, as an engine's binding check does."""
    model = tm.resnet18_like(num_classes=10, dtype=torch.float32).eval()
    engine = sample_aot_compile.build_engine(model, 2, tmp_path / "e.pt2",
                                             CPU)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 224, 224, 3)).astype(np.float32))
    with torch.no_grad():
        want = sample_aot_compile.Serve(model)(x)
    n, top = sample_aot_compile.run([x, x[:1]], engine, 2)
    assert n == 2 and top == (int(want[0][0]), float(want[1][0]))
    cls, conf = engine(x)
    torch.testing.assert_close(cls, want[0], rtol=0, atol=0)
    torch.testing.assert_close(conf, want[1], rtol=1e-5, atol=1e-6)
    with pytest.raises(Exception):
        engine(x[:1])
