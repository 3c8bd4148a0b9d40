"""The port's numpy numerics are exact copies of the JAX package's:
resize matrices, colour matrices, the float64 golden and the plane
geometry; and the CUDA kernel's compact tap tables rebuild the dense
matrices exactly."""

import numpy as np
import pytest

from videoprocessingframework_tpu.core import geometry as jgeometry
from videoprocessingframework_tpu.core.enums import (
    ColorRange as JColorRange,
    ColorSpace as JColorSpace,
    PixelFormat as JPixelFormat,
)
from videoprocessingframework_tpu.ops import colorspace as jcs
from videoprocessingframework_tpu.ops import golden as jgolden
from videoprocessingframework_tpu.ops.resize import (
    resize_matrix as jresize_matrix,
)
from videoprocessingframework_torch.core import geometry
from videoprocessingframework_torch.core.enums import (
    ColorRange,
    ColorSpace,
    PixelFormat,
)
from videoprocessingframework_torch.ops import colorspace as cs
from videoprocessingframework_torch.ops import golden
from videoprocessingframework_torch.ops.fused_cuda import (
    dense_from_taps,
    tap_table,
    tap_tables,
)
from videoprocessingframework_torch.ops.resize import (
    chroma_collapse,
    resize_matrix,
)

COMBOS = [(s, r) for s in (ColorSpace.BT_601, ColorSpace.BT_709)
          for r in (ColorRange.MPEG, ColorRange.JPEG)]


@pytest.mark.parametrize("method", ["lanczos", "bilinear", "nearest"])
@pytest.mark.parametrize(
    "n_in,n_out,window",
    [(1080, 224, None), (2160, 224, None), (464, 61, None),
     (360, 480, None), (48, 97, None), (1080, 224, (100.0, 640.0)),
     (64, 24, (4.5, 40.0))],
)
def test_resize_matrix_equals_jax(n_in, n_out, window, method):
    np.testing.assert_array_equal(
        resize_matrix(n_in, n_out, method, window=window),
        jresize_matrix(n_in, n_out, method, window=window),
    )


@pytest.mark.parametrize("space,rng", COMBOS)
def test_colour_matrices_equal_jax(space, rng):
    js, jr = JColorSpace(int(space)), JColorRange(int(rng))
    for ours, theirs in ((cs.rgb_from_ycbcr_matrix, jcs.rgb_from_ycbcr_matrix),
                         (cs.ycbcr_from_rgb_matrix, jcs.ycbcr_from_rgb_matrix)):
        m, off = ours(space, rng)
        jm, joff = theirs(js, jr)
        np.testing.assert_array_equal(m, jm)
        np.testing.assert_array_equal(off, joff)
    assert {k: {(int(a), int(b)) for a, b in v}
            for k, v in cs.TO_RGB_COMBOS.items()} == \
        {k: {(int(a), int(b)) for a, b in v}
         for k, v in jcs.TO_RGB_COMBOS.items()}


@pytest.mark.parametrize("space,rng", COMBOS)
def test_golden_equals_jax(space, rng):
    r = np.random.default_rng(int(space) * 2 + int(rng))
    h, w = 16, 24
    y = r.integers(0, 256, (h, w), np.uint8)
    u = r.integers(0, 256, (h // 2, w // 2), np.uint8)
    v = r.integers(0, 256, (h // 2, w // 2), np.uint8)
    uv = r.integers(0, 256, (h // 2, w), np.uint8)
    rgb = r.integers(0, 256, (h, w, 3), np.uint8)
    js, jr = JColorSpace(int(space)), JColorRange(int(rng))
    np.testing.assert_array_equal(golden.yuv420_to_rgb(y, u, v, space, rng),
                                  jgolden.yuv420_to_rgb(y, u, v, js, jr))
    np.testing.assert_array_equal(golden.nv12_to_rgb(y, uv, space, rng),
                                  jgolden.nv12_to_rgb(y, uv, js, jr))
    for a, b in zip(golden.rgb_to_yuv420(rgb, space, rng),
                    jgolden.rgb_to_yuv420(rgb, js, jr)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(golden.rgb_to_gray(rgb),
                                  jgolden.rgb_to_gray(rgb))


@pytest.mark.parametrize("fmt", list(PixelFormat))
def test_host_frame_size_equals_jax(fmt):
    if fmt == PixelFormat.UNDEFINED:
        assert fmt not in geometry.PLANE_SPECS
        return
    for w, h in ((1920, 1080), (848, 464), (64, 48)):
        assert geometry.host_frame_size(fmt, w, h) == \
            jgeometry.host_frame_size(JPixelFormat(int(fmt)), w, h)


@pytest.mark.parametrize(
    "n_in,n_out,method,half",
    [(1080, 224, "lanczos", False), (1080, 224, "lanczos", True),
     (2160, 224, "lanczos", False), (2160, 224, "lanczos", True),
     (720, 224, "bilinear", False), (720, 224, "bilinear", True),
     (360, 480, "lanczos", False), (360, 480, "lanczos", True),
     (1920, 224, "lanczos", True), (464, 61, "nearest", True)],
)
def test_tap_table_rebuilds_dense_matrix(n_in, n_out, method, half):
    """The counterpart of the Pallas band plans' invariant: the compact
    per-output windows capture every nonzero of the dense matrix, edge
    clamping included, so rebuilding gives the matrix back exactly."""
    mat = resize_matrix(n_in, n_out, method)
    if half:
        mat = chroma_collapse(mat)
    start, w = tap_table(mat)
    assert w.shape[1] <= (6 if method == "lanczos" else 2)
    assert (start >= 0).all() and (start + w.shape[1] <= mat.shape[1]).all()
    np.testing.assert_array_equal(dense_from_taps(start, w, mat.shape[1]),
                                  mat)


def test_tap_tables_cover_the_kernel_shapes():
    for shape in ((1080, 1920, 224, 224), (2160, 3840, 224, 224),
                  (464, 848, 61, 45)):
        tabs = tap_tables(*shape, "lanczos")
        h, w = shape[:2]
        n_in = {"rows_y": h, "rows_c": h // 2, "cols_y": w, "cols_c": w // 2}
        for name, (start, wt) in tabs.items():
            full = resize_matrix(h if name.startswith("rows") else w,
                                 shape[2] if name.startswith("rows")
                                 else shape[3], "lanczos")
            want = chroma_collapse(full) if name.endswith("_c") else full
            np.testing.assert_array_equal(
                dense_from_taps(start, wt, n_in[name]), want)
