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


# --- where a batch's bytes come from: its page-locked slot or a pinned
# staging buffer (``_RingFeed.upload_stats``)

class _Cudart:
    """A stand-in for ``torch.cuda.cudart()`` that answers every
    ``cudaHostRegister`` with ``rc`` and logs the calls."""

    def __init__(self, rc, real=None):
        self.rc, self.real, self.log = rc, real, []

    def cudaHostRegister(self, ptr, nbytes, flags):
        self.log.append(("register", ptr, nbytes, flags))
        return self.rc

    def cudaHostUnregister(self, ptr):
        self.log.append(("unregister", ptr))
        return self.rc

    def __getattr__(self, name):
        return getattr(self.real, name)


class _Runtime:
    """A stand-in for the CUDA runtime library: counts the clears of its
    last error."""

    def __init__(self):
        self.cleared = 0

    def cudaGetLastError(self):
        self.cleared += 1
        return 0


def test_cpu_ring_counts_every_batch_staged():
    ring = HostBatchRing(32, 16, batch_size=2, n_batches=5, n_buffers=3,
                         seed=4, device="cpu")
    assert len(list(ring.batches(lambda y, u, v: y.clone()))) == 5
    assert ring.upload_stats == {"direct": 0, "staged": 5, "registered": 0,
                                 "register_s": 0.0}
    assert "register" not in ring.timer.counts


@pytest.mark.parametrize("rc, pinned, want, cleared", [
    (0, False, True, 0),      # locked by this call: the caller unlocks it
    (2, False, None, 1),      # refused (out of memory): stays pageable
    (712, True, False, 1),    # locked already, first and last byte
    (712, False, None, 1),    # part of it locked by someone else
], ids=["locked", "refused", "already-locked", "partly-locked"])
def test_page_lock_answers_and_clears_a_refusal(monkeypatch, rc, pinned,
                                                want, cleared):
    from videoprocessingframework_torch.utils import device as dev_mod

    cudart, runtime = _Cudart(rc), _Runtime()
    monkeypatch.setattr(torch.cuda, "cudart", lambda: cudart)
    monkeypatch.setattr(dev_mod, "_cuda_runtime", lambda: runtime)
    monkeypatch.setattr(torch.Tensor, "is_pinned", lambda self: pinned)
    host = torch.zeros(1000, dtype=torch.uint8)
    assert dev_mod.page_lock(host) is want
    assert cudart.log == [("register", host.data_ptr(), 1000, 0)]
    # a refusal is the runtime's last error, which the next kernel launch
    # check would raise: it is cleared at once
    assert runtime.cleared == cleared


def test_page_lock_without_the_runtime_leaves_memory_pageable(monkeypatch):
    from videoprocessingframework_torch.utils import device as dev_mod

    cudart = _Cudart(0)
    monkeypatch.setattr(torch.cuda, "cudart", lambda: cudart)
    monkeypatch.setattr(dev_mod, "_cuda_runtime", lambda: None)
    assert dev_mod.page_lock(torch.zeros(8, dtype=torch.uint8)) is None
    assert cudart.log == []


@pytest.mark.parametrize("rc, cleared", [(0, 0), (713, 1)],
                         ids=["unlocked", "no-longer-held"])
def test_page_unlock_tolerates_a_range_no_longer_held(monkeypatch, rc,
                                                      cleared):
    from videoprocessingframework_torch.utils import device as dev_mod

    cudart, runtime = _Cudart(rc), _Runtime()
    monkeypatch.setattr(torch.cuda, "cudart", lambda: cudart)
    monkeypatch.setattr(dev_mod, "_cuda_runtime", lambda: runtime)
    dev_mod.page_unlock(12345)
    assert cudart.log == [("unregister", 12345)]
    assert runtime.cleared == cleared


def test_slot_locks_lock_each_slot_once_and_unlock_only_their_own(
        monkeypatch):
    from videoprocessingframework_torch.io import pool as pool_mod
    from videoprocessingframework_torch.utils.tracing import StageTimer

    ring = HostBatchRing(32, 16, batch_size=2, n_batches=0, n_buffers=3,
                         device="cpu")
    ptrs = [s.ctypes.data for s in ring._ring]
    # slot 0 locked here, slot 1 refused, slot 2 locked by another owner
    answers = dict(zip(ptrs, [True, None, False]))
    calls, unlocked = [], []

    def lock(t):
        calls.append(t.data_ptr())
        return answers[t.data_ptr()]

    monkeypatch.setattr(pool_mod, "page_lock", lock)
    monkeypatch.setattr(pool_mod, "page_unlock", unlocked.append)
    timer = StageTimer("feed")
    locks = pool_mod._SlotLocks(timer)
    got = [locks.direct_from(s) for s in ring._ring * 2]
    assert got == [True, False, True] * 2
    assert calls == ptrs  # once a slot
    assert locks.stats["registered"] == 1
    assert locks.stats["register_s"] > 0
    assert timer.counts == {"register": 3}
    locks.unlock()
    assert unlocked == ptrs[:1]
    locks.unlock()
    assert unlocked == ptrs[:1]


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _pinned(slot) -> bool:
    return torch.from_numpy(slot).is_pinned()


def _host_planes(batches):
    return [tuple(p.cpu() for p in b) for b in batches]


@pytest.mark.cuda
def test_cuda_ring_dmas_every_batch_from_its_slots(monkeypatch):
    dev = _cuda()
    ring = HostBatchRing(256, 128, batch_size=4, n_batches=7, n_buffers=3,
                         seed=5, device=dev)
    direct = _host_planes(ring.batches(depth=2))
    assert ring.upload_stats["direct"] == 7
    assert ring.upload_stats["staged"] == 0
    assert ring.upload_stats["registered"] == 3
    assert not any(_pinned(s) for s in ring._ring)  # unlocked at the end
    # registration refused: the same ring through the staged path gives
    # byte-equal batches
    refusing = _Cudart(2, torch.cuda.cudart())
    monkeypatch.setattr(torch.cuda, "cudart", lambda: refusing)
    staged = _host_planes(ring.rewind(7).batches(depth=2))
    stats = ring.upload_stats
    assert (stats["direct"], stats["staged"], stats["registered"]) == \
        (0, 7, 0)
    assert [c[0] for c in refusing.log] == ["register"] * 3
    for a, b in zip(direct, staged):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    # a refusal left no error behind for the next kernel launch
    assert float((torch.ones(4, device=dev) * 2).sum()) == 8.0


@pytest.mark.cuda
def test_cuda_ring_unlocks_its_slots_on_early_close():
    dev = _cuda()
    ring = HostBatchRing(256, 128, batch_size=4, n_batches=9, n_buffers=4,
                         seed=6, device=dev)
    gen = ring.batches(lambda y, u, v: y.float().mean(), depth=3)
    next(gen)
    # three batches dispatched so far: three slots locked
    assert [_pinned(s) for s in ring._ring] == [True] * 3 + [False]
    gen.close()
    assert ring.held == 0
    assert not any(_pinned(s) for s in ring._ring)
    assert ring.upload_stats["registered"] == 3


@pytest.mark.cuda
def test_cuda_second_generator_leaves_the_first_ones_locks():
    dev = _cuda()
    ring = HostBatchRing(256, 128, batch_size=4, n_batches=12, n_buffers=3,
                         seed=7, device=dev)
    first = ring.batches(lambda y, u, v: y.clone(), depth=1)
    want = [next(first) for _ in range(3)]  # locks slots 0-2
    second = ring.batches(lambda y, u, v: y.clone(), depth=1)
    got = next(second)  # slot 0 again: locked already
    assert torch.equal(got, want[0])
    stats = ring.upload_stats
    assert (stats["direct"], stats["registered"]) == (1, 0)
    second.close()
    assert all(_pinned(s) for s in ring._ring)  # the first one's locks
    first.close()
    assert not any(_pinned(s) for s in ring._ring)
    assert float((torch.ones(4, device=dev) * 2).sum()) == 8.0


class _Overwriting(HostBatchRing):
    """A ring whose decode workers refill a slot the moment it is
    released."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.order = []

    def _acquire_raw(self):
        k = self._next
        slot, n = super()._acquire_raw()
        if slot is not None:
            self.order.append(k)
        return slot, n

    def release(self):
        self._ring[self.order.pop(0)][:] = 0
        super().release()


@pytest.mark.cuda
def test_cuda_slot_written_over_after_release_leaves_yielded_batches():
    dev = _cuda()
    ring = _Overwriting(256, 128, batch_size=4, n_batches=4, n_buffers=4,
                        seed=8, device=dev)
    want = [torch.from_numpy(s.copy()) for s in ring._ring]
    got = [torch.cat([p.reshape(-1) for p in b]).cpu()
           for b in ring.batches(depth=2)]
    assert ring.upload_stats["direct"] == 4
    assert not any(s.any() for s in ring._ring)  # every slot overwritten
    for g, w in zip(got, want):
        assert torch.equal(g, w)
