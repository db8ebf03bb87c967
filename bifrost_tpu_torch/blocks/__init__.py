"""Pipeline blocks of the port (counterparts of bifrost_tpu/blocks)."""

from .accumulate import accumulate, AccumulateBlock
from .beamform import beamform, BeamformBlock
from .calibrate import broadcast_gains, gaincal, GainCalBlock
from .copy import copy, CopyBlock
from .correlate import correlate, CorrelateBlock
from .detect import detect, DetectBlock
from .fdmt import fdmt, FdmtBlock
from .fft import fft, FftBlock
from .fftshift import fftshift, FftShiftBlock
from .fir import fir, FirBlock
from .flag import rfi_flag, RfiFlagBlock
from .map import map_block, MapBlock
from .guppi_raw import (read_guppi_raw, GuppiRawSourceBlock,
                        write_guppi_raw, GuppiRawSinkBlock)
from .pfb import pfb, PfbBlock
from .quantize import quantize, QuantizeBlock
from .reduce import reduce, ReduceBlock
from .reverse import reverse, ReverseBlock
from .romein import romein, GridderBlock
from .scrunch import scrunch, ScrunchBlock
from .sigproc import (read_sigproc, SigprocSourceBlock, write_sigproc,
                      SigprocSinkBlock)
from .testing import (array_source, ArraySourceBlock, callback_sink,
                      CallbackSinkBlock, gather_sink)
from .transpose import transpose, TransposeBlock
from .udp_capture import udp_capture, UDPCaptureBlock
from .unpack import unpack, UnpackBlock
from .convert_visibilities import (convert_visibilities,
                                   ConvertVisibilitiesBlock)
from .print_header import print_header, PrintHeaderBlock
from .binary_io import (BinaryFileReadBlock, BinaryFileWriteBlock,
                        binary_read, binary_write)
from .wav import read_wav, WavSourceBlock, write_wav, WavSinkBlock
from .serialize import (serialize, SerializeBlock, deserialize,
                        DeserializeBlock)
from .shmring import shm_send, ShmSendBlock, shm_receive, ShmReceiveBlock
# Live audio: PortAudio resolved at first use, raising clearly without it.
from .audio import read_audio, AudioSourceBlock
from .psrdada import (read_psrdada_buffer, PsrDadaSourceBlock,
                      dada_shm_send, DadaShmSendBlock, dada_ipc_send,
                      DadaIpcSinkBlock, parse_dada_header,
                      serialize_dada_header)

__all__ = ["accumulate", "AccumulateBlock", "beamform", "BeamformBlock",
           "broadcast_gains", "gaincal", "GainCalBlock", "copy",
           "CopyBlock", "correlate", "CorrelateBlock", "detect",
           "DetectBlock", "fdmt", "FdmtBlock", "fft", "FftBlock",
           "fftshift", "FftShiftBlock", "fir", "FirBlock", "rfi_flag",
           "RfiFlagBlock",
           "read_guppi_raw", "GuppiRawSourceBlock", "write_guppi_raw",
           "GuppiRawSinkBlock", "map_block", "MapBlock", "pfb", "PfbBlock", "reduce", "ReduceBlock",
           "reverse", "ReverseBlock", "romein", "GridderBlock", "scrunch",
           "ScrunchBlock", "read_sigproc", "SigprocSourceBlock",
           "write_sigproc", "SigprocSinkBlock", "array_source",
           "ArraySourceBlock", "callback_sink", "CallbackSinkBlock",
           "gather_sink", "transpose", "TransposeBlock", "udp_capture",
           "UDPCaptureBlock", "quantize", "QuantizeBlock", "unpack",
           "UnpackBlock", "convert_visibilities",
           "ConvertVisibilitiesBlock", "print_header", "PrintHeaderBlock",
           "BinaryFileReadBlock", "BinaryFileWriteBlock", "binary_read",
           "binary_write", "read_wav", "WavSourceBlock", "write_wav",
           "WavSinkBlock", "serialize", "SerializeBlock", "deserialize",
           "DeserializeBlock", "shm_send", "ShmSendBlock", "shm_receive",
           "ShmReceiveBlock", "read_audio", "AudioSourceBlock",
           "read_psrdada_buffer", "PsrDadaSourceBlock", "dada_shm_send",
           "DadaShmSendBlock", "dada_ipc_send", "DadaIpcSinkBlock",
           "parse_dada_header", "serialize_dada_header"]
