"""The port's InferenceServer on the CPU against the JAX package's model
functions on the same items: matches-direct, concurrent submitters,
validation and errors, tuple outputs and buckets, backpressure, and the
decode → preprocess → model composition; then the pinned-staging / event
path on the card (marked ``cuda``; it skips without one)."""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videoprocessingframework_tpu.core.enums import (
    ColorRange as JColorRange,
    ColorSpace as JColorSpace,
    PixelFormat as JPixelFormat,
)
from videoprocessingframework_tpu.ops.fused import (
    decode_postproc as jax_postproc,
)
from videoprocessingframework_torch.core.enums import (
    ColorRange,
    ColorSpace,
    PixelFormat,
)
from videoprocessingframework_torch.models import (
    from_jax_variables,
    resnet18_like,
)
from videoprocessingframework_torch.ops.fused import FusedPipeline
from videoprocessingframework_torch.serving import (
    InferenceServer,
    ServingQueueFull,
)

SHAPE = (8, 12, 3)
CPU = dict(device="cpu")


def _weights():
    return np.random.default_rng(0).random((np.prod(SHAPE), 16), np.float32)


def _jax_model():
    w = jnp.asarray(_weights())
    return jax.jit(lambda batch: batch.reshape(batch.shape[0], -1).astype(
        jnp.float32) @ w)


def _model():
    """The same per-item checksum map in torch."""
    w = torch.from_numpy(_weights())
    return lambda batch: batch.reshape(batch.shape[0], -1).float() @ w


def _items(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, SHAPE, np.uint8) for _ in range(n)]


def test_serving_matches_direct_and_batches():
    items = _items(23, 0)
    want = np.asarray(_jax_model()(np.stack(items)))
    with InferenceServer(_model(), SHAPE, max_batch=8, max_wait_ms=20.0,
                         **CPU) as srv:
        srv.warmup()
        futs = srv.submit_many(items)
        got = np.stack([f.result(timeout=60).numpy() for f in futs])
    # float32 matmuls of u8 items on both sides, summed in other orders
    np.testing.assert_allclose(got, want, rtol=1e-5)
    snap = srv.snapshot()
    assert snap["requests"] == 23
    assert snap["batches"] < 23  # batching happened
    # split stats: each part bounded by the end-to-end number
    assert snap["queue_wait_ms_p50"] <= snap["latency_ms_p99"] + 1e-6
    assert snap["dispatch_ms_p50"] <= snap["latency_ms_p99"] + 1e-6
    assert snap["queue_wait_ms_p99"] >= 0.0
    assert snap["dispatch_ms_p99"] > 0.0


def test_serving_concurrent_submitters():
    items = _items(40, 7)
    want = np.asarray(_jax_model()(np.stack(items)))
    results: dict = {}
    with InferenceServer(_model(), SHAPE, max_batch=16, max_wait_ms=5.0,
                         **CPU) as srv:
        srv.warmup()

        def client(lo, hi):
            for i in range(lo, hi):
                results[i] = srv.infer(items[i], timeout=60).numpy()

        threads = [threading.Thread(target=client,
                                    args=(i * 10, (i + 1) * 10))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    got = np.stack([results[i] for i in range(40)])
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_serving_many_submitters_under_fast_switching():
    """More client threads than cores, the interpreter switching threads
    every microsecond: every request is answered with its own row and
    counted once."""
    import sys

    items = _items(8, 13)
    want = np.asarray(_jax_model()(np.stack(items)))
    n_clients, per_client = 16, 24
    got = {}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with InferenceServer(_model(), SHAPE, max_batch=8, max_wait_ms=0.5,
                             **CPU) as srv:
            def client(c):
                futs = [(k, srv.submit(items[(c + k) % 8]))
                        for k in range(per_client)]
                got[c] = [(k, f.result(timeout=60).numpy()) for k, f in futs]

            threads = [threading.Thread(target=client, args=(c,))
                       for c in range(n_clients)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    for c, rows in got.items():
        for k, row in rows:
            np.testing.assert_allclose(row, want[(c + k) % 8], rtol=1e-5)
    assert srv.snapshot()["requests"] == n_clients * per_client


def test_serving_validation_and_errors():
    with InferenceServer(_model(), SHAPE, max_batch=4, **CPU) as srv:
        with pytest.raises(ValueError, match="item shape"):
            srv.submit(np.zeros((3, 3), np.uint8))
        with pytest.raises(ValueError, match="item shape"):
            srv.submit_many([np.zeros(SHAPE, np.uint8),
                             np.zeros((3, 3), np.uint8)])
    with pytest.raises(ValueError, match="max_queue"):
        InferenceServer(_model(), SHAPE, max_queue=0, **CPU)

    calls = {"n": 0}

    def broken(batch):
        calls["n"] += 1
        raise RuntimeError("boom")

    with InferenceServer(broken, SHAPE, max_batch=4, **CPU) as srv:
        with pytest.raises(RuntimeError, match="boom"):
            srv.warmup()
        fut = srv.submit(np.zeros(SHAPE, np.uint8))
        with pytest.raises(RuntimeError, match="boom"):
            fut.result(timeout=30)
        # the collector survives a failed batch
        fut = srv.submit(np.zeros(SHAPE, np.uint8))
        with pytest.raises(RuntimeError, match="boom"):
            fut.result(timeout=30)
    assert calls["n"] == 3
    with pytest.raises(RuntimeError, match="closed"):
        srv.submit(np.zeros(SHAPE, np.uint8))
    with pytest.raises(RuntimeError, match="closed"):
        srv.warmup()


def test_serving_tuple_outputs_and_buckets():
    seen = []

    def fn(batch):
        seen.append((batch.shape[0], threading.current_thread().name))
        x = batch.float()
        return x.sum(dim=(1, 2, 3)), x.reshape(x.shape[0], -1)[:, :4]

    jfn = jax.jit(lambda b: b.astype(jnp.float32).sum(axis=(1, 2, 3)))
    a = np.full(SHAPE, 2, np.uint8)
    with InferenceServer(fn, SHAPE, buckets=[2, 4], max_wait_ms=0.0,
                         **CPU) as srv:
        srv.warmup()
        # one warm-up call per bucket, on the collector thread (where
        # infer_fn runs: library handles are per thread)
        assert seen == [(2, "vpf-serving"), (4, "vpf-serving")]
        s, head = srv.infer(a, timeout=60)
    assert float(s) == float(jfn(a[None])[0]) == 2.0 * np.prod(SHAPE)
    assert head.shape == (4,)
    assert seen[-1][0] == 2  # one request padded up to the smallest bucket
    assert srv.snapshot()["padded_items"] == 1


def test_serving_composition_matches_jax():
    """Seeded YUV420 frames → the port's FusedPipeline(kernel="torch") →
    resnet18_like carried across from Flax, served, against the JAX
    decode_postproc + model.apply on the same frames, float32 on both
    sides."""
    # Flax is imported here, not at the top, so that the card's machine
    # (JAX without Flax) collects this file for its cuda test
    from test_torch_resnet import _random_variables
    from videoprocessingframework_tpu.models import resnet as jresnet

    h, w = 464, 848
    jm = jresnet.resnet18_like(num_classes=5, dtype=jnp.float32)
    variables = _random_variables(jm, (1, 32, 32, 3), seed=2)
    frames = list(np.random.default_rng(3).integers(
        0, 256, (6, h * 3 // 2, w), np.uint8))

    @jax.jit
    def jax_fn(packed):
        x = jax_postproc(packed, src_format=JPixelFormat.YUV420,
                         space=JColorSpace.BT_709, rng=JColorRange.MPEG,
                         out_h=32, out_w=32, output="rgb_f32",
                         compute="highest")
        return jm.apply(variables, x, train=False)

    want = np.asarray(jax_fn(np.stack(frames)))

    pipe = FusedPipeline(PixelFormat.YUV420, ColorSpace.BT_709,
                         ColorRange.MPEG, (32, 32), output="rgb_f32",
                         kernel="torch", **CPU)
    model = resnet18_like(num_classes=5, dtype=torch.float32).eval()
    model.load_state_dict(from_jax_variables(variables))

    def serve_fn(packed):
        with torch.no_grad():
            return model(pipe(packed))

    with InferenceServer(serve_fn, (h * 3 // 2, w), max_batch=4,
                         max_wait_ms=10.0, **CPU) as srv:
        futs = srv.submit_many(frames)
        got = np.stack([f.result(timeout=120).numpy() for f in futs])
    # float32 end to end; a rounding-boundary flip of an input pixel
    # moves no logit by more than this
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_serving_backpressure():
    release = threading.Event()

    def slow(batch):
        release.wait(timeout=30)
        return batch.float().sum(dim=(1, 2, 3))

    srv = InferenceServer(slow, SHAPE, buckets=[1], max_wait_ms=0.0,
                          max_queue=2, **CPU)
    try:
        futs = [srv.submit(np.zeros(SHAPE, np.uint8))]
        time.sleep(0.2)  # the collector takes the first and blocks
        futs += [srv.submit(np.zeros(SHAPE, np.uint8)) for _ in range(2)]
        with pytest.raises(ServingQueueFull, match="queue full"):
            srv.submit(np.zeros(SHAPE, np.uint8))
        # submit_many is all or nothing
        with pytest.raises(ServingQueueFull):
            srv.submit_many([np.zeros(SHAPE, np.uint8)] * 2)
        release.set()
        for f in futs:
            assert float(f.result(timeout=30)) == 0.0
        assert srv.snapshot()["requests"] == 3
    finally:
        release.set()
        srv.close()


@pytest.mark.cuda
def test_serving_cuda_pinned_staging_and_events():
    """Each batch's copy from its pinned staging tensor is held behind a
    device-side sleep: a collector that refilled a staging tensor before
    the batch that read it had landed would serve another batch's rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    w = torch.from_numpy(_weights()).cuda()

    def fn(staging):
        assert staging.is_pinned()
        torch.cuda._sleep(2_000_000)  # the copy below waits on the device
        x = staging.to("cuda", non_blocking=True)
        return x.reshape(x.shape[0], -1).float() @ w

    items = _items(100, 11)
    want = np.asarray(_jax_model()(np.stack(items)))
    with InferenceServer(fn, SHAPE, max_batch=8, max_wait_ms=1.0,
                         device="cuda") as srv:
        srv.warmup()
        futs = srv.submit_many(items)
        out = [f.result(timeout=120) for f in futs]
    assert all(o.is_cuda for o in out)
    got = np.stack([o.cpu().numpy() for o in out])
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert srv.snapshot()["batches"] >= 100 // 8
