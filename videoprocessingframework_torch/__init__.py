"""PyTorch/CUDA port of videoprocessingframework_tpu for NVIDIA Hopper.

Six paths run on the card:

* host libav decode (io/pool.py) → one hand-written CUDA kernel for
  resize + colour conversion (ops/fused_cuda.py,
  csrc/fused_resize_csc.cu) → ResNet (models/resnet.py);
* host frames → device ``Surface`` (interop/transfer.py) →
  ``SurfaceConverter`` (ops/convert.py; NV12 / YUV420 → RGB_PLANAR through
  the CUDA kernel of ops/csc_cuda.py, csrc/csc_rgb_planar.cu) → zero-copy
  tensor export or host download (interop/);
* requests → ``InferenceServer`` (serving.py: dynamic batching, pinned
  staging, CUDA events) → the fused kernel → the models of models/
  (ResNet, ViT / VideoViT, VideoClassifier, FCN);
* training: video files → ``VideoReader`` (io/decoder.py) →
  ``VideoClipLoader`` (data/: pinned ring, one upload a batch on a side
  stream) → the fused kernel, or ``AugmentPipeline`` + ``mixup_cutmix``
  (ops/augment.py) → ``make_train_step`` (parallel/train.py);
* the encode side: device RGB → ``encode_feed`` (ops/fused.py) → host
  planes → ``VideoEncoder`` → ``StreamMuxer`` (io/), ``Transcoder``,
  ``MultiStreamPipeline`` (parallel/streams.py), and the reference's API
  (compat.py);
* the split MJPEG codec: host entropy decode (io/jpeg.py over
  io/native/jpeg.cpp, ``libvpf_jpeg``, which needs no libav) → device
  dequant + IDCT (ops/jpeg.py) → the fused kernel; device fDCT + quant →
  host entropy encode; ``JpegDeviceTranscoder``, ``MjpegReader`` /
  ``MjpegWriter`` / ``MjpegTranscoder`` and ``MjpegClipLoader``
  (data/mjpeg.py).

The stages that demux, decode or encode through libav need its
development files where the package is built. The device analysis ops
(ops/metrics.py, flow.py, stabilize.py, scenecut.py) are plain torch, as
the JAX package left them to XLA.
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
    UnseekableInputError,
    UnsupportedConversion,
)
from .core.packet import (  # noqa: F401
    ColorspaceConversionContext,
    MuxingParams,
    PacketData,
    SeekContext,
)
from .core.surface import HostBuffer, Surface, SurfacePlane  # noqa: F401
from .data.mjpeg import MjpegClipLoader  # noqa: F401
from .ops.convert import SurfaceConverter  # noqa: F401
from .ops.remap import SurfaceRemaper  # noqa: F401
from .ops.resize import SurfaceResizer  # noqa: F401


def __getattr__(name):
    """``make_mesh`` on first use: ``torch.distributed.tensor`` takes
    a second or more to import, which single-device users need not pay."""
    if name == "make_mesh":
        from .parallel.mesh import make_mesh

        return make_mesh
    raise AttributeError(name)
