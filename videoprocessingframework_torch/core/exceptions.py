"""Typed exceptions mirroring the reference's failure-detection contract.

The reference converts low-level decoder failures into two Python-visible
exception types so callers can retry (PyNvDecoder.cpp:590-615,
PyNvCodec.cpp:217-219). The names are kept so existing error-handling
code (e.g. samples/SampleDecode.py's HwResetException recovery loop) ports
unchanged; the "Hw" being reset here is the host codec context.
"""

from __future__ import annotations


class HwResetException(RuntimeError):
    """Decoder hit an unrecoverable error and was re-created.

    The decoder object remains usable: the failing codec context has been
    torn down and rebuilt. Callers should treat in-flight frames as lost and
    continue feeding packets (typically after seeking to a key frame).
    """


class CuvidParserException(RuntimeError):
    """Bitstream-parse failure (malformed or mis-described input)."""


class BitstreamParserException(CuvidParserException):
    """Preferred alias: parse failures are not cuvid-specific here."""


class UnsupportedConversion(ValueError):
    """Requested (input, output, colorspace, range) combo is unsupported."""


class EncoderException(RuntimeError):
    """Encoder session failure (bad options, codec error, flush error)."""


class CudaArrayInterfaceUnsupported(TypeError):
    """``__cuda_array_interface__`` was asked of an object that has none.

    The reference exports the CAI protocol for nvcv/cupy/numba
    (PyNvDecoder.cpp:822-923). In this package a device Surface's planes
    are ``torch.Tensor``s, which carry their own ``__cuda_array_interface__``
    and DLPack export; this typed error (instead of a bare AttributeError)
    tells a cupy-style consumer to ask the plane tensor
    (``interop.surface_to_torch``) instead.
    """


class UnseekableInputError(RuntimeError):
    """The demuxer refused a seek because the input has no index (a raw
    elementary stream). The demux and decode sessions are left as they
    were, so a caller may emulate the seek by decoding forward."""
