"""Reference-compatible API surface: the ``PyNvCodec`` namespace over the
port (the counterpart of the JAX package's ``compat.py``).

Code written against the reference's Python module runs on the port with
``import videoprocessingframework_torch.compat as nvc``: the same class
names, overload shapes, out-parameter conventions (caller-supplied numpy
arrays resized and filled, PacketData structs mutated in place),
empty-Surface EOF signalling and exception types. Signatures mirror
``PyNvCodec/__init__.pyi``; behaviour mirrors src/PyNvCodec/src/*.cpp.

Devices: an integer ``gpu_id`` is ``cuda:<gpu_id>`` and raises without
CUDA; ``gpu_id="cpu"`` (or a ``torch.device``) asks for the CPU. Raw
``(context, stream)`` handles are accepted and ignored with one
``logging.warning`` per process: the work is ordered on the current
torch stream of device 0. Device planes are torch tensors, so
``GpuMem()`` is the tensor's ``data_ptr()``. ``__cuda_array_interface__``
raises the typed :class:`CudaArrayInterfaceUnsupported`, pointing at
DLPack and ``interop.surface_to_torch``, as the JAX package does.
"""

from __future__ import annotations

import ctypes
import enum
import logging
import sys
from typing import Dict, Optional, Union

import numpy as np
import torch

from .core.enums import (
    CodecId as CudaVideoCodec,  # reference name
    ColorRange,
    ColorSpace,
    PixelFormat,
    SeekMode,
)
from .core.exceptions import (
    CudaArrayInterfaceUnsupported,
    CuvidParserException,
    HwResetException,
    UnsupportedConversion,
)
from .core.packet import ColorspaceConversionContext, MuxingParams, PacketData
from .core.packet import SeekContext as _CoreSeekContext
from .core.surface import Surface as _CoreSurface
from .core.surface import _np_dtype
from .interop.transfer import FrameUploader as _Uploader
from .interop.transfer import SurfaceDownloader as _Downloader
from .io.decoder import DecodedFrame, VideoDecoder, VideoReader, codec_caps
from .io.demuxer import FFmpegDemuxer as _Demuxer
from .io.encoder import VideoEncoder, get_encoder_params
from .ops.convert import SurfaceConverter as _Converter
from .ops.remap import SurfaceRemaper as _Remaper
from .ops.resize import SurfaceResizer as _Resizer
from .utils.device import resolve_device, to_device


class NV_DEC_CAPS(enum.IntEnum):
    """Decoder capability keys: the reference binding's members and
    ordinals (PyNvDecoder.cpp:675-689 over Tasks.hpp:83-98)."""

    BIT_DEPTH_MINUS_8 = 0
    IS_CODEC_SUPPORTED = 1
    OUTPUT_FORMAT_MASK = 2
    MAX_WIDTH = 3
    MAX_HEIGHT = 4
    MAX_MB_COUNT = 5
    MIN_WIDTH = 6
    MIN_HEIGHT = 7
    IS_HIST_SUPPORTED = 8
    HIST_COUNT_BIT_DEPTH = 9
    HIST_COUNT_BINS = 10


class NV_ENC_CAPS(enum.IntEnum):
    """Encoder capability keys: the reference binding's members and
    ordinals (PyNvEncoder.cpp:471-523 over nvEncodeAPI.h's NV_ENC_CAPS);
    EXPOSED_COUNT keeps its C ordinal (51)."""

    NUM_MAX_BFRAMES = 0
    SUPPORTED_RATECONTROL_MODES = 1
    SUPPORT_FIELD_ENCODING = 2
    SUPPORT_MONOCHROME = 3
    SUPPORT_FMO = 4
    SUPPORT_QPELMV = 5
    SUPPORT_BDIRECT_MODE = 6
    SUPPORT_CABAC = 7
    SUPPORT_ADAPTIVE_TRANSFORM = 8
    SUPPORT_STEREO_MVC = 9
    NUM_MAX_TEMPORAL_LAYERS = 10
    SUPPORT_HIERARCHICAL_PFRAMES = 11
    SUPPORT_HIERARCHICAL_BFRAMES = 12
    LEVEL_MAX = 13
    LEVEL_MIN = 14
    SEPARATE_COLOUR_PLANE = 15
    WIDTH_MAX = 16
    HEIGHT_MAX = 17
    SUPPORT_TEMPORAL_SVC = 18
    SUPPORT_DYN_RES_CHANGE = 19
    SUPPORT_DYN_BITRATE_CHANGE = 20
    SUPPORT_DYN_FORCE_CONSTQP = 21
    SUPPORT_DYN_RCMODE_CHANGE = 22
    SUPPORT_SUBFRAME_READBACK = 23
    SUPPORT_CONSTRAINED_ENCODING = 24
    SUPPORT_INTRA_REFRESH = 25
    SUPPORT_CUSTOM_VBV_BUF_SIZE = 26
    SUPPORT_DYNAMIC_SLICE_MODE = 27
    SUPPORT_REF_PIC_INVALIDATION = 28
    PREPROC_SUPPORT = 29
    ASYNC_ENCODE_SUPPORT = 30
    MB_NUM_MAX = 31
    MB_PER_SEC_MAX = 32
    SUPPORT_YUV444_ENCODE = 33
    SUPPORT_LOSSLESS_ENCODE = 34
    SUPPORT_SAO = 35
    SUPPORT_MEONLY_MODE = 36
    SUPPORT_LOOKAHEAD = 37
    SUPPORT_TEMPORAL_AQ = 38
    SUPPORT_10BIT_ENCODE = 39
    NUM_MAX_LTR_FRAMES = 40
    SUPPORT_WEIGHTED_PREDICTION = 41
    DYNAMIC_QUERY_ENCODER_CAPACITY = 42
    SUPPORT_BFRAME_REF_MODE = 43
    SUPPORT_EMPHASIS_LEVEL_MAP = 44
    WIDTH_MIN = 45
    HEIGHT_MIN = 46
    SUPPORT_MULTIPLE_REF_FRAMES = 47
    SUPPORT_ALPHA_LAYER_ENCODING = 48
    EXPOSED_COUNT = 51


def GetNumGpus() -> int:
    """Number of CUDA devices (PyNvCodec.cpp:427 analog)."""
    return torch.cuda.device_count()


def GetNvencParams() -> Dict[str, str]:
    return get_encoder_params()


def _device(gpu_id=0) -> torch.device:
    """``cuda:<gpu_id>`` for an integer id; ``"cpu"``, a device string or
    a ``torch.device`` as given. Raises without CUDA unless the CPU was
    asked for."""
    if isinstance(gpu_id, int) and not isinstance(gpu_id, bool):
        return resolve_device(f"cuda:{gpu_id}")
    return resolve_device(gpu_id)


_handles_warned = False


def _consume_handles(cls_name: str, gpu_id, extra):
    """Normalize the reference's pycuda ctor flavor: raw ``(context,
    stream)`` int handles in place of ``gpu_id``. They are accepted and
    ignored, with one ``logging.warning`` per process, since a context
    handle landing in the gpu_id slot is exactly where a porting bug
    would hide. Returns the device id to use (0 for the handle flavor)."""
    if extra and isinstance(gpu_id, int) and all(
        isinstance(a, int) and not isinstance(a, bool) for a in extra
    ):
        global _handles_warned
        if not _handles_warned:
            _handles_warned = True
            logging.warning(
                "%s: raw (context, stream) CUDA handles were passed and are "
                "ignored: the work is ordered on the current torch stream "
                "of device 0. Pass gpu_id=<device index> to pick a device. "
                "(warned once per process)", cls_name,
            )
        return 0
    return gpu_id


def _fill_out_array(out: np.ndarray, data: np.ndarray) -> None:
    """Reference out-param convention: resize the caller's array, fill it."""
    data = np.ascontiguousarray(data).reshape(-1).view(out.dtype)
    try:
        out.resize(data.shape, refcheck=False)
    except ValueError:
        raise ValueError(
            "output array must own its memory (create with numpy.ndarray/"
            "numpy.empty)") from None
    out[...] = data


def _append_out_array(out: np.ndarray, data: np.ndarray) -> None:
    data = np.ascontiguousarray(data).reshape(-1).view(out.dtype)
    old = out.size
    out.resize((old + data.size,), refcheck=False)
    out[old:] = data


def _copy_pkt(dst: PacketData, src: PacketData) -> None:
    dst.key, dst.pts, dst.dts = src.key, src.pts, src.dts
    dst.pos, dst.bsl, dst.duration = src.pos, src.bsl, src.duration


def _core(surface):
    return surface._core if isinstance(surface, Surface) else surface


class SeekContext(_CoreSeekContext):
    """Reference-spelled ctor: SeekContext(seek_frame=…) or (seek_ts=…)."""

    def __init__(self, seek_frame: Optional[Union[int, float]] = None,
                 mode: SeekMode = SeekMode.PREV_KEY_FRAME,
                 seek_ts: Optional[float] = None, **kw):
        if seek_ts is None and isinstance(seek_frame, float):
            seek_frame, seek_ts = None, seek_frame
        super().__init__(
            seek_frame=-1 if seek_frame is None else int(seek_frame),
            seek_tssec=-1.0 if seek_ts is None else float(seek_ts),
            mode=mode, **kw)


_CAI_MSG = (
    "{what}: __cuda_array_interface__ is not exported. Use DLPack instead "
    "(torch.from_dlpack({arg})) or "
    "videoprocessingframework_torch.interop.surface_to_torch, which give "
    "the plane's tensor without a copy.")


class SurfacePlane:
    """Reference-spelled view of one plane."""

    def __init__(self, core_plane):
        self._p = core_plane

    def Width(self) -> int:
        return self._p.width

    def Height(self) -> int:
        return self._p.height

    def Pitch(self) -> int:
        return self._p.pitch

    def ElemSize(self) -> int:
        return self._p.elem_size

    def HostFrameSize(self) -> int:
        return self._p.host_frame_size

    def GpuMem(self) -> int:
        """Address of the plane's memory: the tensor's ``data_ptr()``."""
        arr = self._p.array
        if isinstance(arr, np.ndarray):
            return arr.ctypes.data
        return arr.data_ptr()

    # DLPack: torch.from_dlpack(surface.PlanePtr(i)) gives the plane's
    # tensor without a copy (the reference's NVCV/CAI export analog)
    def __dlpack__(self, **kwargs):
        return self._p.array.__dlpack__(**kwargs)

    def __dlpack_device__(self):
        return self._p.array.__dlpack_device__()

    @property
    def __cuda_array_interface__(self):
        raise CudaArrayInterfaceUnsupported(
            _CAI_MSG.format(what="SurfacePlane", arg="plane"))

    @property
    def __array_interface__(self):
        """The numpy protocol for a host (numpy) plane; a tensor plane
        raises the typed error, pointing at DLPack."""
        arr = self._p.array
        if isinstance(arr, np.ndarray):
            return arr.__array_interface__
        raise CudaArrayInterfaceUnsupported(
            "this SurfacePlane holds a torch tensor: no host buffer "
            "protocol. Use DLPack (torch.from_dlpack(plane)) or a Surface "
            "download.")

    @staticmethod
    def _pitched_view(addr: int, h: int, pitch: int, row: int) -> np.ndarray:
        """(h, row) uint8 view over pitched raw host memory at ``addr``."""
        n = (h - 1) * pitch + row  # the last row needs only `row` bytes
        flat = np.ctypeslib.as_array((ctypes.c_uint8 * n).from_address(addr))
        return np.lib.stride_tricks.as_strided(flat, shape=(h, row),
                                               strides=(pitch, 1))

    def Export(self, dst: int, dst_pitch: int, *args) -> None:
        """Copy this plane into raw host memory at ``dst`` (an address),
        honouring ``dst_pitch`` (reference SurfacePlane::Export)."""
        data = np.ascontiguousarray(self._p.export())
        h, row = self._p.height, self._p.pitch
        self._pitched_view(dst, h, dst_pitch, row)[:] = (
            data.view(np.uint8).reshape(h, row))

    def Import(self, src: int, src_pitch: int, *args) -> None:
        """Fill this plane from raw host memory at ``src``; a device plane
        is written in place."""
        h, row = self._p.height, self._p.pitch
        buf = np.array(self._pitched_view(src, h, src_pitch, row))
        self._p.import_from(buf.view(_np_dtype(self._p.array)))

    def __repr__(self):
        return repr(self._p)


class Surface:
    """Reference-spelled Surface over the port's Surface."""

    def __init__(self, core: _CoreSurface):
        self._core = core

    @classmethod
    def Make(cls, format: PixelFormat, width: int, height: int,
             gpu_id=0) -> "Surface":
        return cls(_CoreSurface.make(format, width, height, _device(gpu_id)))

    @classmethod
    def _empty(cls, format: PixelFormat) -> "Surface":
        # an empty Surface holds no data: the reference's EOF marker
        return cls(_CoreSurface.make(format, 0, 0, "cpu"))

    @property
    def core(self) -> _CoreSurface:
        return self._core

    #: packed 3-channel formats report Width() in pixels (reference
    #: SurfaceRGB::Width = plane.Width()/3, MemoryInterfaces.cpp:1382-1389)
    _PACKED3 = (PixelFormat.RGB, PixelFormat.BGR, PixelFormat.RGB_32F)

    def Width(self, plane: int = 0) -> int:
        if self.Empty():
            return 0
        w = self._core.plane(plane).width
        return w // 3 if self._core.format in self._PACKED3 else w

    def Height(self, plane: int = 0) -> int:
        return self._core.plane(plane).height if not self.Empty() else 0

    def Pitch(self, plane: int = 0) -> int:
        return self._core.plane(plane).pitch if not self.Empty() else 0

    def Format(self) -> PixelFormat:
        return self._core.format

    def Empty(self) -> bool:
        return self._core.empty()

    def NumPlanes(self) -> int:
        return self._core.num_planes

    def HostSize(self) -> int:
        return self._core.host_size

    def OwnMemory(self) -> bool:
        return True

    def PlanePtr(self, plane: int = 0) -> SurfacePlane:
        return SurfacePlane(self._core.plane(plane))

    def Clone(self, *args) -> "Surface":
        return Surface(self._core.clone())

    def CopyFrom(self, other: "Surface", *args) -> None:
        self._core.copy_from(other._core)

    def Crop(self, x: int, y: int, w: int, h: int, *args) -> "Surface":
        return Surface(self._core.crop(x, y, w, h))

    def __repr__(self):
        return repr(self._core)


class NVCVImage:
    """NVCV ``Image`` analog (the reference builds ``nvcv.as_image`` over
    the decoded surface, PyNvDecoder.cpp:822-923). Lowercase
    ``width``/``height`` as the reference sample reads them, the packed
    frame by DLPack, and accepted by ``PyNvEncoder.EncodeFromNVCVImage``."""

    def __init__(self, surface: "Surface"):
        self._surface = surface
        self._packed = None

    @property
    def width(self) -> int:
        return self._surface.Width()

    @property
    def height(self) -> int:
        return self._surface.Height()

    @property
    def format(self) -> PixelFormat:
        return self._surface.Format()

    @property
    def surface(self) -> "Surface":
        return self._surface

    def packed(self):
        """The whole frame as one array on the planes' device: the plane
        itself for one plane, a row concatenation when the planes share a
        row width (NV12: (H*3/2, W) u8), else a byte concatenation."""
        if self._packed is None:
            # numpy planes are wrapped, not copied
            planes = [torch.as_tensor(p) for p in self._surface.core.planes]
            if len(planes) == 1:
                self._packed = planes[0]
            elif len({p.shape[-1] for p in planes}) == 1:
                self._packed = torch.cat(planes, dim=0)
            else:
                self._packed = torch.cat(
                    [p.reshape(-1).view(torch.uint8) for p in planes])
        return self._packed

    def __dlpack__(self, **kwargs):
        return self.packed().__dlpack__(**kwargs)

    def __dlpack_device__(self):
        return self.packed().__dlpack_device__()

    @property
    def __cuda_array_interface__(self):
        raise CudaArrayInterfaceUnsupported(
            _CAI_MSG.format(what="NVCVImage", arg="image"))

    def __repr__(self):
        return (f"NVCVImage({self.width}x{self.height}, "
                f"{self._surface.Format().name})")


class CudaBuffer:
    """1-D device memory (reference CudaBuffer) held as a uint8 tensor."""

    def __init__(self, elem_size: int, num_elems: int, array=None,
                 gpu_id=0):
        self._elem_size = elem_size
        self._num_elems = num_elems
        if array is None:
            array = torch.zeros(elem_size * num_elems, dtype=torch.uint8,
                                device=_device(gpu_id))
        self._array = array

    @classmethod
    def Make(cls, elem_size: int, num_elems: int, gpu_id=0) -> "CudaBuffer":
        return cls(elem_size, num_elems, gpu_id=gpu_id)

    def GetElemSize(self) -> int:
        return self._elem_size

    def GetNumElems(self) -> int:
        return self._num_elems

    def GetRawMemSize(self) -> int:
        return self._elem_size * self._num_elems

    def GpuMem(self) -> int:
        return self._array.data_ptr()

    def Clone(self, *args) -> "CudaBuffer":
        return CudaBuffer(self._elem_size, self._num_elems,
                          self._array.clone())

    def CopyFrom(self, other: "CudaBuffer", *args) -> None:
        """Copy ``other``'s contents into this buffer in place, so an
        address taken by ``GpuMem()`` stays valid (cuMemcpyDtoD into the
        existing allocation, as the reference does)."""
        if other.GetRawMemSize() != self.GetRawMemSize():
            raise ValueError("CopyFrom: size mismatch")
        self._array.copy_(to_device(other._array, self._array.device))

    def to_numpy(self) -> np.ndarray:
        return self._array.cpu().numpy()


def _tensor_to_numpy(tensor) -> np.ndarray:
    """Any frame object (numpy, a tensor on any device, an NVCVImage or a
    DLPack exporter) as a host numpy array for the host encoder."""
    if isinstance(tensor, NVCVImage):
        tensor = tensor.packed()
    if isinstance(tensor, np.ndarray):
        return tensor
    if isinstance(tensor, torch.Tensor):
        return tensor.detach().cpu().numpy()
    if hasattr(tensor, "__dlpack__"):
        return torch.from_dlpack(tensor).cpu().numpy()
    return np.asarray(tensor)


class PyFFmpegDemuxer:
    """src/PyNvCodec/src/PyFFMpegDemuxer.cpp analog."""

    def __init__(self, input: str, opts: Optional[Dict[str, str]] = None):
        self._d = _Demuxer(input, opts)

    def Width(self) -> int:
        return self._d.width

    def Height(self) -> int:
        return self._d.height

    def Framerate(self) -> float:
        return self._d.framerate

    def AvgFramerate(self) -> float:
        return self._d.avg_framerate

    def IsVFR(self) -> bool:
        return self._d.is_vfr

    def Timebase(self) -> float:
        return self._d.timebase

    def Numframes(self) -> int:
        return self._d.num_frames

    def Format(self) -> PixelFormat:
        return self._d.format

    def ColorSpace(self) -> ColorSpace:
        return self._d.color_space

    def ColorRange(self) -> ColorRange:
        return self._d.color_range

    def Codec(self) -> CudaVideoCodec:
        return self._d.codec

    def DemuxSinglePacket(self, packet: np.ndarray,
                          sei: Optional[np.ndarray] = None) -> bool:
        res = self._d.demux(need_sei=sei is not None)
        if res is None:
            return False
        _fill_out_array(packet, res.packet)
        if sei is not None:
            _fill_out_array(sei, res.sei if res.sei is not None
                            else np.empty(0, np.uint8))
        return True

    def Seek(self, seek_ctx: _CoreSeekContext, pkt: np.ndarray) -> bool:
        res = self._d.seek(seek_ctx)
        if res is None:
            return False
        _fill_out_array(pkt, res.packet)
        return True

    def LastPacketData(self, pkt_data: PacketData) -> None:
        _copy_pkt(pkt_data, self._d.last_packet_data)

    def Flush(self) -> None:
        self._d.flush()


class PyNvDecoder:
    """src/PyNvCodec/src/PyNvDecoder.cpp analog (host libav decode, frames
    uploaded to the session's device).

    Ctors: (input, gpu_id[, opts]) with the built-in demuxer; (width,
    height, format, codec, gpu_id) for packets the caller demuxes; int
    (context, stream) pairs accepted in place of gpu_id.
    """

    def __init__(self, *args, **kw):
        self._gpu_id = 0
        if args and isinstance(args[0], str):
            rest = args[1:]
            opts = kw.get("opts")
            ids = [a for a in rest if not isinstance(a, dict)]
            for a in rest:
                if isinstance(a, dict):
                    opts = a
            if len(ids) == 1:
                self._gpu_id = ids[0]
            elif len(ids) >= 2:  # pycuda (context, stream) flavor
                self._gpu_id = _consume_handles("PyNvDecoder", ids[0],
                                                ids[1:])
            self._device = _device(self._gpu_id)
            self._reader = VideoReader(args[0], opts, device=self._device)
        else:
            width, height, fmt, codec = args[:4]
            rest = args[4:]
            if rest:
                self._gpu_id = (
                    rest[0] if len(rest) == 1
                    else _consume_handles("PyNvDecoder", rest[0], rest[1:]))
            self._device = _device(self._gpu_id)
            self._reader = VideoReader(
                codec=CudaVideoCodec(codec), width=width, height=height,
                format=PixelFormat(fmt), device=self._device)
        self._format = self._reader.format

    # -- metadata (the reference's error contract without a demuxer) --------

    def Width(self) -> int:
        return self._reader.width()

    def Height(self) -> int:
        return self._reader.height()

    def ColorSpace(self) -> ColorSpace:
        return self._reader.color_space()

    def ColorRange(self) -> ColorRange:
        return self._reader.color_range()

    def Framerate(self) -> float:
        return self._reader.framerate()

    def AvgFramerate(self) -> float:
        return self._reader.avg_framerate()

    def IsVFR(self) -> bool:
        return self._reader.is_vfr()

    def Timebase(self) -> float:
        return self._reader.timebase()

    def Numframes(self) -> int:
        return self._reader.num_frames()

    def Framesize(self) -> int:
        return self._reader.frame_size()

    def Format(self) -> PixelFormat:
        return self._format

    def LastPacketData(self, pkt_data: PacketData) -> None:
        _copy_pkt(pkt_data, self._reader.last_packet_data())

    def Capabilities(self) -> Dict[NV_DEC_CAPS, int]:
        """Decoder capabilities for this session's codec, queried from
        libav (NvDecoder.cpp:183-210 analog)."""
        codec = self._reader.decoder.codec
        caps = codec_caps(codec, encoder=False)
        depth = 8
        if self._reader.demuxer is not None:
            depth = self._reader.demuxer.bit_depth or 8
        # output-format bits (cudaVideoSurfaceFormat): bit0 NV12, bit1 P016,
        # bit2 YUV444, bit3 YUV444_16
        has444 = codec in (CudaVideoCodec.H264, CudaVideoCodec.HEVC,
                           CudaVideoCodec.VP9)
        fmt_mask = 1 | (2 if caps["supports_10bit"] else 0)
        if has444:
            fmt_mask |= 4 | (8 if caps["supports_10bit"] else 0)
        return {
            NV_DEC_CAPS.BIT_DEPTH_MINUS_8: max(0, depth - 8),
            NV_DEC_CAPS.IS_CODEC_SUPPORTED: caps["is_supported"],
            NV_DEC_CAPS.OUTPUT_FORMAT_MASK: fmt_mask,
            NV_DEC_CAPS.MAX_WIDTH: caps["max_width"],
            NV_DEC_CAPS.MAX_HEIGHT: caps["max_height"],
            NV_DEC_CAPS.MAX_MB_COUNT: (caps["max_width"] // 16)
            * (caps["max_height"] // 16),
            NV_DEC_CAPS.MIN_WIDTH: caps["min_width"],
            NV_DEC_CAPS.MIN_HEIGHT: caps["min_height"],
            # the software decoder has no histogram engine
            NV_DEC_CAPS.IS_HIST_SUPPORTED: 0,
            NV_DEC_CAPS.HIST_COUNT_BIT_DEPTH: 0,
            NV_DEC_CAPS.HIST_COUNT_BINS: 0,
        }

    # -- decode core ---------------------------------------------------------

    @staticmethod
    def _sort_extras(extras):
        """Classify overload extras: (sei_array, seek_ctx, pkt_data)."""
        sei = seek = pkt = None
        for a in extras:
            if isinstance(a, np.ndarray):
                sei = a
            elif isinstance(a, _CoreSeekContext):
                seek = a
            elif isinstance(a, PacketData):
                pkt = a
            elif a is not None:
                raise TypeError(f"unexpected argument {type(a)}")
        return sei, seek, pkt

    def _decode(self, sei, seek, pkt_out, packet=None, enc_pkt_data=None,
                flush=False) -> Optional[DecodedFrame]:
        frame = self._reader.decode(
            packet=packet, packet_data=enc_pkt_data, seek_ctx=seek,
            need_sei=sei is not None, flush=flush)
        if frame is None:
            return None
        if sei is not None:
            s = self._reader.last_sei()
            _fill_out_array(sei, s if s is not None else np.empty(0, np.uint8))
        if pkt_out is not None:
            _copy_pkt(pkt_out, frame.pkt_data)
        return frame

    def _surface(self, frame: Optional[DecodedFrame]) -> Surface:
        if frame is None:
            return Surface._empty(self._format)
        return Surface(frame.to_surface(self._device))

    def DecodeSingleSurface(self, *extras) -> Surface:
        sei, seek, pkt = self._sort_extras(extras)
        return self._surface(self._decode(sei, seek, pkt))

    def DecodeSingleFrame(self, frame: np.ndarray, *extras) -> bool:
        sei, seek, pkt = self._sort_extras(extras)
        decoded = self._decode(sei, seek, pkt)
        if decoded is None:
            return False
        _fill_out_array(frame, decoded.data)
        return True

    @staticmethod
    def _from_packet(args) -> tuple:
        """(enc_pkt_data, packet, pkt_data) from overload args."""
        enc_pkt = pkt_out = None
        arrays = [a for a in args if isinstance(a, np.ndarray)]
        pds = [a for a in args if isinstance(a, PacketData)]
        packet = arrays[0] if arrays else None
        if len(pds) == 2:
            enc_pkt, pkt_out = pds
        elif len(pds) == 1:
            # PacketData BEFORE the packet is the packet's metadata; after
            # it, the output packet data (the reference's overload order)
            if isinstance(args[0], PacketData):
                enc_pkt = pds[0]
            else:
                pkt_out = pds[0]
        return enc_pkt, packet, pkt_out

    def DecodeSurfaceFromPacket(self, *args) -> Surface:
        # NVCV-output overload (PyNvDecoder.cpp:822-923): a trailing bool
        # asks for an NVCVImage over the decoded surface
        nvcv_check = None
        if args and isinstance(args[-1], bool):
            nvcv_check = args[-1]
            args = args[:-1]
        if nvcv_check is False:
            # the reference's contract: a message and None
            print("Please set value of bOutputNVCVImage to true")
            return None
        enc_pkt, packet, pkt_out = self._from_packet(args)
        surf = self._surface(self._decode(None, None, pkt_out, packet=packet,
                                          enc_pkt_data=enc_pkt))
        return NVCVImage(surf) if nvcv_check else surf

    def DecodeFrameFromPacket(self, frame: np.ndarray, *args) -> bool:
        enc_pkt, packet, pkt_out = self._from_packet(args)
        decoded = self._decode(None, None, pkt_out, packet=packet,
                               enc_pkt_data=enc_pkt)
        if decoded is None:
            return False
        _fill_out_array(frame, decoded.data)
        return True

    def FlushSingleSurface(self, *extras) -> Surface:
        _, _, pkt = self._sort_extras(extras)
        return self._surface(self._decode(None, None, pkt, flush=True))

    def FlushSingleFrame(self, frame: np.ndarray, *extras) -> bool:
        _, _, pkt = self._sort_extras(extras)
        decoded = self._decode(None, None, pkt, flush=True)
        if decoded is None:
            return False
        _fill_out_array(frame, decoded.data)
        return True


class PyFfmpegDecoder:
    """src/PyNvCodec/src/PyFFMpegDecoder.cpp analog (software decode with
    motion vectors)."""

    def __init__(self, input: str, opts: Optional[Dict[str, str]] = None,
                 gpu_id=0):
        self._demuxer = _Demuxer(input, opts)
        self._decoder = VideoDecoder(self._demuxer.codec, threads=0,
                                     export_mvs=True)  # 0 = libav auto
        self._device = _device(gpu_id)
        self._eof = False

    def Width(self) -> int:
        return self._demuxer.width

    def Height(self) -> int:
        return self._demuxer.height

    def Framerate(self) -> float:
        return self._demuxer.framerate

    def Codec(self) -> CudaVideoCodec:
        return self._demuxer.codec

    def Format(self) -> PixelFormat:
        return self._demuxer.format

    def ColorSpace(self) -> ColorSpace:
        return self._demuxer.color_space

    def ColorRange(self) -> ColorRange:
        return self._demuxer.color_range

    def _next_frame(self) -> Optional[DecodedFrame]:
        while not self._eof:
            res = self._demuxer.demux()
            if res is None:
                self._eof = True
                break
            frame = self._decoder.decode_packet(res.packet, res.pkt_data)
            if frame is not None:
                return frame
        return self._decoder.flush_frame()

    def DecodeSingleFrame(self, frame: np.ndarray) -> bool:
        decoded = self._next_frame()
        if decoded is None:
            return False
        _fill_out_array(frame, decoded.data)
        return True

    def DecodeSingleSurface(self) -> Surface:
        decoded = self._next_frame()
        if decoded is None:
            return Surface._empty(self._demuxer.format)
        return Surface(decoded.to_surface(self._device))

    def GetMotionVectors(self) -> np.ndarray:
        return self._decoder.motion_vectors()


class PyNvEncoder:
    """src/PyNvCodec/src/PyNvEncoder.cpp analog (host libav encode; a
    device Surface or tensor is downloaded by a copy the host waits for)."""

    def __init__(self, settings: Dict[str, str], *args, format=None,
                 verbose: bool = False, **kw):
        gpu_id = args[0] if args else 0
        if len(args) >= 2:  # pycuda (context, stream) flavor
            gpu_id = _consume_handles("PyNvEncoder", gpu_id, args[1:])
        opts = dict(settings)
        if format is not None:
            opts.setdefault("fmt", PixelFormat(format).name)
        try:
            self._enc = VideoEncoder(opts, device=_device(gpu_id))
        except ValueError as e:
            # the reference's error type for bad options
            raise RuntimeError(str(e)) from None
        self._last_pkt_data = PacketData()

    def Width(self) -> int:
        return self._enc.width

    def Height(self) -> int:
        return self._enc.height

    def Format(self) -> PixelFormat:
        return self._enc.format

    def GetFrameSizeInBytes(self) -> int:
        return self._enc.frame_size_in_bytes()

    def Capabilities(self) -> Dict[NV_ENC_CAPS, int]:
        """Encoder capabilities for this session's codec: every
        NV_ENC_CAPS key but EXPOSED_COUNT, from libav queries (pixel
        formats for 10-bit, the private option table for lookahead,
        dimension limits) plus per-codec facts about what the option
        vocabulary exposes; features the software path lacks report 0."""
        codec = CudaVideoCodec[self._enc.opts.get("codec", "h264").upper()]
        caps = codec_caps(codec, encoder=True)
        h26x = codec in (CudaVideoCodec.H264, CudaVideoCodec.HEVC)
        bframes = caps["max_bframes"]
        K = NV_ENC_CAPS
        out = {k: 0 for k in K if k != K.EXPOSED_COUNT}
        out.update({
            K.NUM_MAX_BFRAMES: bframes,
            # constqp | vbr | cbr: the rc modes the option vocabulary maps
            K.SUPPORTED_RATECONTROL_MODES: 0x1 | 0x2 | 0x4,
            K.SUPPORT_MONOCHROME: int(codec == CudaVideoCodec.HEVC),
            K.SUPPORT_QPELMV: int(h26x),
            K.SUPPORT_BDIRECT_MODE: int(codec == CudaVideoCodec.H264),
            K.SUPPORT_CABAC: int(h26x),
            K.SUPPORT_ADAPTIVE_TRANSFORM: int(codec == CudaVideoCodec.H264),
            K.SUPPORT_HIERARCHICAL_PFRAMES: int(h26x),
            K.SUPPORT_HIERARCHICAL_BFRAMES: int(h26x and bframes > 0),
            K.LEVEL_MAX: 62 if h26x else 0,
            K.LEVEL_MIN: 10 if h26x else 0,
            K.WIDTH_MAX: caps["max_width"],
            K.HEIGHT_MAX: caps["max_height"],
            # Reconfigure(reset_encoder) handles these mid-stream
            K.SUPPORT_DYN_RES_CHANGE: 1,
            K.SUPPORT_DYN_BITRATE_CHANGE: 1,
            K.SUPPORT_CUSTOM_VBV_BUF_SIZE: 1,
            K.MB_NUM_MAX: (caps["max_width"] // 16)
            * (caps["max_height"] // 16),
            K.SUPPORT_YUV444_ENCODE: int(h26x or codec == CudaVideoCodec.VP9),
            K.SUPPORT_LOSSLESS_ENCODE: int(h26x),  # constqp initqp=0
            K.SUPPORT_SAO: int(codec == CudaVideoCodec.HEVC),
            K.SUPPORT_LOOKAHEAD: caps["supports_lookahead"],
            K.SUPPORT_TEMPORAL_AQ: int(h26x),
            K.SUPPORT_10BIT_ENCODE: caps["supports_10bit"],
            K.SUPPORT_WEIGHTED_PREDICTION: int(h26x),
            K.SUPPORT_BFRAME_REF_MODE: int(h26x and bframes > 0),
            K.WIDTH_MIN: caps["min_width"],
            K.HEIGHT_MIN: caps["min_height"],
            K.SUPPORT_MULTIPLE_REF_FRAMES: int(h26x),  # numrefl0/l1
        })
        return out

    def _encode(self, data, packet, sei, sync, append) -> bool:
        out = self._enc.encode(
            data, sei=None if sei is None else bytes(np.asarray(sei)),
            sync=sync)
        if out is None:
            return False
        self._last_pkt_data = out[1]
        (_append_out_array if append else _fill_out_array)(packet, out[0])
        return True

    def LastPacketData(self, pkt_data: PacketData) -> None:
        """Extension: pts/dts/key of the last packet returned (needed to
        mux the encoder's output into a container)."""
        _copy_pkt(pkt_data, self._last_pkt_data)

    def EncodeSingleSurface(self, surface, packet: np.ndarray, sei=None,
                            sync=False, append=False) -> bool:
        return self._encode(_core(surface), packet, sei, sync, append)

    def EncodeSingleFrame(self, frame: np.ndarray, packet: np.ndarray,
                          sei=None, sync=False, append=False) -> bool:
        return self._encode(np.asarray(frame), packet, sei, sync, append)

    def EncodeFromNVCVImage(self, image, packet: np.ndarray,
                            is_nvcv_image: bool = True) -> bool:
        """Encode from an image object (PyNvEncoder.cpp:401-460): an
        NVCVImage, a tensor, a numpy array or any DLPack exporter holding
        one packed frame in the encoder's input layout. Returns False with
        a message when ``is_nvcv_image`` is not set, as the reference."""
        if not is_nvcv_image:
            print("Please set the boolean to true", file=sys.stderr)
            return False
        return self.EncodeFromTensor(image, packet)

    def EncodeFromTensor(self, tensor, packet: np.ndarray, sei=None,
                         sync: bool = False, append: bool = False) -> bool:
        """Encode one frame from a tensor-like object (no Surface)."""
        arr = _tensor_to_numpy(tensor)
        if arr.dtype not in (np.uint8, np.uint16):
            raise TypeError("EncodeFromTensor: expected uint8/uint16 frame "
                            f"data, got {arr.dtype}")
        return self._encode(np.ascontiguousarray(arr), packet, sei, sync,
                            append)

    def FlushSinglePacket(self, packet: np.ndarray) -> bool:
        out = self._enc.flush_single_packet()
        if out is None:
            return False
        self._last_pkt_data = out[1]
        _fill_out_array(packet, out[0])
        return True

    def Flush(self, packets: np.ndarray) -> bool:
        got = False
        for pkt, _ in self._enc.flush():
            _append_out_array(packets, pkt)
            got = True
        return got

    def Reconfigure(self, settings: Dict[str, str], force_idr: bool = False,
                    reset_encoder: bool = False,
                    verbose: bool = False) -> bool:
        return self._enc.reconfigure(settings, force_idr, reset_encoder)


class PySurfaceConverter:
    """src/PyNvCodec/src/PySurfaceConverter.cpp analog: converts on the
    device the Surface's planes are on."""

    def __init__(self, width, height, src_format, dst_format, gpu_id=0,
                 *args):
        self._device = _device(_consume_handles("PySurfaceConverter",
                                                gpu_id, args))
        try:
            self._conv = _Converter(width, height, src_format, dst_format)
        except UnsupportedConversion as e:
            raise ValueError(str(e)) from None
        self._dst_format = PixelFormat(dst_format)

    def Format(self) -> PixelFormat:
        return self._dst_format

    def Execute(self, surface, cc_ctx=None) -> Surface:
        try:
            out = self._conv.run(_core(surface), cc_ctx)
        except UnsupportedConversion:
            # the reference returns an empty surface on failure
            return Surface._empty(self._dst_format)
        return Surface(out)


class PySurfaceResizer:
    def __init__(self, width, height, format, gpu_id=0, *args):
        self._device = _device(_consume_handles("PySurfaceResizer", gpu_id,
                                                args))
        self._resizer = _Resizer(width, height, format)
        self._format = PixelFormat(format)

    def Format(self) -> PixelFormat:
        return self._format

    def Execute(self, surface) -> Surface:
        return Surface(self._resizer.run(_core(surface)))


class PySurfaceRemaper:
    def __init__(self, x_map, y_map, format=PixelFormat.RGB, gpu_id=0,
                 *args):
        dev = _device(_consume_handles("PySurfaceRemaper", gpu_id, args))
        self._remaper = _Remaper(np.asarray(x_map), np.asarray(y_map),
                                 PixelFormat(format), device=dev)
        self._format = PixelFormat(format)

    def Format(self) -> PixelFormat:
        return self._format

    def Execute(self, surface) -> Surface:
        return Surface(self._remaper.run(_core(surface)))


class PyFrameUploader:
    """Host frame → device Surface (src/PyNvCodec/src/PyFrameUploader.cpp),
    over the pinned-staging uploader."""

    def __init__(self, width, height, format, gpu_id=0, *args):
        self._format = PixelFormat(format)
        self._gpu_id = _consume_handles("PyFrameUploader", gpu_id, args)
        self._up = _Uploader(width, height, self._format,
                             device=_device(self._gpu_id))

    def Format(self) -> PixelFormat:
        return self._format

    def UploadSingleFrame(self, frame: np.ndarray) -> Surface:
        return Surface(self._up.upload(np.ascontiguousarray(frame)))


class PySurfaceDownloader:
    """Device Surface → host frame, over the pinned-staging downloader."""

    def __init__(self, width, height, format, gpu_id=0, *args):
        self._gpu_id = _consume_handles("PySurfaceDownloader", gpu_id, args)
        self._format = PixelFormat(format)
        self._down = _Downloader(width, height, self._format)

    def Format(self) -> PixelFormat:
        return self._format

    def DownloadSingleSurface(self, surface, frame: np.ndarray) -> bool:
        core = _core(surface)
        if core.empty():
            return False
        _fill_out_array(frame, self._down.download(core))
        return True


class PyBufferUploader:
    def __init__(self, elem_size, num_elems, gpu_id=0, *args):
        self._elem_size = elem_size
        self._num_elems = num_elems
        self._gpu_id = _consume_handles("PyBufferUploader", gpu_id, args)
        self._device = _device(self._gpu_id)

    def UploadSingleBuffer(self, array: np.ndarray) -> CudaBuffer:
        flat = np.ascontiguousarray(array).reshape(-1).view(np.uint8)
        if flat.nbytes != self._elem_size * self._num_elems:
            raise ValueError("buffer size mismatch")
        # the caller keeps its array: the buffer gets its own copy
        dev = to_device(flat.copy(), self._device)
        return CudaBuffer(self._elem_size, self._num_elems, dev)


class PyCudaBufferDownloader:
    def __init__(self, elem_size, num_elems, gpu_id=0, *args):
        _consume_handles("PyCudaBufferDownloader", gpu_id, args)
        self._elem_size = elem_size
        self._num_elems = num_elems

    def DownloadSingleCudaBuffer(self, buffer: CudaBuffer,
                                 array: np.ndarray) -> bool:
        _fill_out_array(array, buffer.to_numpy())
        return True


#: structured dtype of GetMotionVectors() rows (reference MotionVector)
MotionVector = np.dtype([
    ("source", np.int32), ("w", np.uint8), ("h", np.uint8),
    ("src_x", np.int16), ("src_y", np.int16), ("dst_x", np.int16),
    ("dst_y", np.int16), ("flags", np.uint64), ("motion_x", np.int32),
    ("motion_y", np.int32), ("motion_scale", np.uint16),
])

__all__ = [
    "CudaBuffer",
    "MotionVector",
    "CudaVideoCodec",
    "ColorRange",
    "ColorSpace",
    "ColorspaceConversionContext",
    "CudaArrayInterfaceUnsupported",
    "CuvidParserException",
    "GetNumGpus",
    "GetNvencParams",
    "HwResetException",
    "MuxingParams",
    "NVCVImage",
    "NV_DEC_CAPS",
    "NV_ENC_CAPS",
    "PacketData",
    "PixelFormat",
    "PyBufferUploader",
    "PyCudaBufferDownloader",
    "PyFFmpegDemuxer",
    "PyFfmpegDecoder",
    "PyFrameUploader",
    "PyNvDecoder",
    "PyNvEncoder",
    "PySurfaceConverter",
    "PySurfaceDownloader",
    "PySurfaceRemaper",
    "PySurfaceResizer",
    "SeekContext",
    "SeekMode",
    "Surface",
    "SurfacePlane",
]
