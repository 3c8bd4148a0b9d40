"""The port's decode pool against the JAX package's, on the CPU; the
seeded ring's batches on the CPU and on the card."""

import numpy as np
import pytest
import torch

from videoprocessingframework_tpu.io import NativeDecodePool as JaxPool
from videoprocessingframework_torch.core.enums import PixelFormat
from videoprocessingframework_torch.io import HostBatchRing, NativeDecodePool

#: the CPU, and the card where there is one (``-m cuda``)
DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]


def _drain_planes(pool):
    out = []
    while True:
        b = pool.acquire_planes()
        if b is None:
            return out
        out.append(tuple(np.array(p) for p in b))
        pool.release()


def test_pool_planes_bit_equal_to_jax_pool(test_mp4, gt):
    ours = NativeDecodePool([test_mp4], batch_size=8,
                            out_format=PixelFormat.YUV420, plane_major=True,
                            device="cpu")
    theirs = JaxPool([test_mp4], batch_size=8, out_format=4, plane_major=True)
    assert (ours.width, ours.height) == (gt["width"], gt["height"])
    assert (int(ours.color_space), int(ours.color_range)) == \
        (int(theirs.color_space), int(theirs.color_range))
    a, b = _drain_planes(ours), _drain_planes(theirs)
    assert sum(p[0].shape[0] for p in a) == gt["num_frames"]
    assert ours.frames_decoded == theirs.frames_decoded == gt["num_frames"]
    assert (ours.frames_dropped, ours.drop_reason) == (0, "")
    assert len(a) == len(b)
    for pa, pb in zip(a, b):
        for x, y in zip(pa, pb):
            np.testing.assert_array_equal(x, y)


def test_pool_packed_frames_bit_equal_to_jax_pool(test_mp4):
    ours = NativeDecodePool([test_mp4], batch_size=16, device="cpu")
    theirs = JaxPool([test_mp4], batch_size=16)
    while True:
        a, b = ours.acquire(), theirs.acquire()
        assert (a is None) == (b is None)
        if a is None:
            break
        np.testing.assert_array_equal(a, b)
        ours.release()
        theirs.release()


def test_batches_equal_postproc_of_planes(test_mp4):
    """batches() hands postproc the same frames acquire_planes() sees,
    and copies them out of the ring on the CPU (no aliasing)."""
    ref = _drain_planes(
        NativeDecodePool([test_mp4], batch_size=8, out_format=4,
                         plane_major=True, device="cpu")
    )
    pool = NativeDecodePool([test_mp4], batch_size=8, out_format=4,
                            plane_major=True, device="cpu")

    def post(y, u, v):
        return y.to(torch.int64).sum((1, 2)), u.sum(), v.clone()

    got = list(pool.batches(post, depth=2))
    assert len(got) == len(ref)
    for (sy, su, v), (y, u, vv) in zip(got, ref):
        np.testing.assert_array_equal(sy.numpy(),
                                      y.astype(np.int64).sum((1, 2)))
        assert su.item() == u.astype(np.int64).sum()
        np.testing.assert_array_equal(v.numpy(), vv)
    # the CPU path: no staging buffer to wait for and no upload
    assert set(pool.timer.summary()) == {"acquire", "dispatch", "stage",
                                         "postproc", "drain"}


def test_packed_batches_feed_postproc(test_mp4):
    pool = NativeDecodePool([test_mp4], batch_size=32, device="cpu")
    shapes = [b[0].shape for b in pool.batches()]
    assert shapes == [(32, 464 * 3 // 2, 848)] * 3


class _Ring(HostBatchRing):
    """HostBatchRing that logs acquire/release order."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.log = []

    def _acquire_raw(self):
        slot, n = super()._acquire_raw()
        if slot is not None:
            self.log.append("acquire")
        return slot, n

    def release(self):
        self.log.append("release")
        super().release()


def test_slot_released_only_after_its_batch_drains():
    ring = _Ring(64, 32, batch_size=2, n_batches=5, n_buffers=4,
                 device="cpu")
    seen = []
    for out in ring.batches(lambda y, u, v: y.clone(), depth=2):
        # the batch just yielded was drained: its slot is free, the next
        # batch's slot (depth 2) is still held
        seen.append(ring.held)
    assert seen == [1, 1, 1, 1, 0]
    assert ring.log[:3] == ["acquire", "acquire", "release"]
    assert ring.held == 0


def test_early_close_frees_held_slots():
    ring = _Ring(64, 32, batch_size=2, n_batches=8, n_buffers=4,
                 device="cpu")
    gen = ring.batches(lambda y, u, v: y.clone(), depth=3)
    next(gen)
    assert ring.held == 2
    gen.close()
    assert ring.held == 0


def test_early_close_of_native_pool_frees_slots(test_mp4):
    pool = NativeDecodePool([test_mp4], batch_size=8, out_format=4,
                            plane_major=True, n_buffers=3, device="cpu")
    gen = pool.batches(depth=2)
    next(gen)
    gen.close()  # must release the held slot, or the pool would stall
    rest = _drain_planes(pool)
    assert sum(p[0].shape[0] for p in rest) == 96 - 8 * 2


@pytest.mark.parametrize("device", DEVICES)
def test_host_ring_batches_are_its_slots(device):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    ring = HostBatchRing(48, 16, batch_size=3, n_batches=2, n_buffers=2,
                         seed=1, device=device)
    got = list(ring.batches())
    for (y, u, v), slot in zip(got, ring._ring):
        assert y.device.type == device
        flat = torch.from_numpy(slot)
        np.testing.assert_array_equal(y.reshape(-1).cpu().numpy(),
                                      flat[: 3 * 16 * 48].numpy())
        np.testing.assert_array_equal(
            torch.cat([u.reshape(-1), v.reshape(-1)]).cpu().numpy(),
            flat[3 * 16 * 48:].numpy())
        assert u.shape == v.shape == (3, 8, 24)


def test_make_clip_decodes_through_the_pool(tmp_path):
    """The encoder binding makes a clip the port's pool decodes: the
    frame count and the clip's moving gradient come back (within codec
    loss)."""
    from videoprocessingframework_torch.io.encoder import make_clip

    w, h, n = 128, 64, 12
    clip = make_clip(tmp_path / "clip.h264", w, h, n)
    pool = NativeDecodePool([str(clip)], batch_size=4, out_format=4,
                            plane_major=True, device="cpu")
    frames = _drain_planes(pool)
    assert (pool.width, pool.height) == (w, h)
    assert sum(p[0].shape[0] for p in frames) == n
    ys = np.arange(h)[:, None]
    xs = np.arange(w)[None, :]
    want = ((ys * 2 + xs + 3 * 7) % 256).astype(np.int64)
    got = frames[0][0][3].astype(np.int64)
    # away from the 255→0 wrap edges the gradient survives encoding
    smooth = (want > 16) & (want < 240)
    assert np.median(np.abs(got - want)[smooth]) <= 4


def test_pool_device_defaults_to_cuda(test_mp4, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        NativeDecodePool([test_mp4], batch_size=8)
