"""PyTorch/CUDA port of videoprocessingframework_tpu for NVIDIA Hopper.

Three paths run on the card:

* host libav decode (io/pool.py) → one hand-written CUDA kernel for
  resize + colour conversion (ops/fused_cuda.py,
  csrc/fused_resize_csc.cu) → ResNet (models/resnet.py);
* host frames → device ``Surface`` (interop/transfer.py) →
  ``SurfaceConverter`` (ops/convert.py; NV12 / YUV420 → RGB_PLANAR through
  the CUDA kernel of ops/csc_cuda.py, csrc/csc_rgb_planar.cu) → zero-copy
  tensor export or host download (interop/);
* requests → ``InferenceServer`` (serving.py: dynamic batching, pinned
  staging, CUDA events) → the fused kernel → the models of models/
  (ResNet, ViT / VideoViT, VideoClassifier, FCN).

The device analysis ops (ops/metrics.py, flow.py, stabilize.py,
scenecut.py) are plain torch, as the JAX package left them to XLA.
"""

__version__ = "0.1.0"

from .core.enums import (  # noqa: F401
    CodecId,
    ColorRange,
    ColorSpace,
    PixelFormat,
    SeekMode,
)
from .core.exceptions import (  # noqa: F401
    CudaArrayInterfaceUnsupported,
    CuvidParserException,
    HwResetException,
    UnsupportedConversion,
)
from .core.packet import (  # noqa: F401
    ColorspaceConversionContext,
    MuxingParams,
    PacketData,
    SeekContext,
)
from .core.surface import HostBuffer, Surface, SurfacePlane  # noqa: F401
from .ops.convert import SurfaceConverter  # noqa: F401
from .ops.remap import SurfaceRemaper  # noqa: F401
from .ops.resize import SurfaceResizer  # noqa: F401
