"""The service pieces of the port (counterpart of
bifrost_tpu/service.py): the `FrameLedger`, the `CandidateDetectBlock`,
and two chains built from the port's blocks, with an in-memory replay
source in place of UDP capture:

- `frb_search_pipeline`, the body of `frb_search_spec`
  (service.py:294-315):

      array_source (u8 [time, freq]) -> copy('cuda') [-> rfi_flag] ->
      transpose(['freq', 'time']) -> fdmt(max_delay) -> CandidateDetectBlock

- `lwa_beam_search_pipeline`, the B-engine branch of
  `lwa_instrument_spec` (service.py:443-534):

      array_source (ci8 [time, station, pol]) -> copy('cuda') ->
      pfb(nchan, ntap) -> beamform(weights, n_int) ->
      transpose(['beam', 'freq', 'time']) -> fdmt(max_delay) ->
      CandidateDetectBlock

- `lwa_instrument_pipeline`, the whole instrument of
  `lwa_instrument_spec` (service.py:355-550): the B branch above and the
  X/imaging branch, both reading one PFB ring:

      ... pfb -> correlate(n_int) -> transpose(['freq', 'station_i',
      'pol_i', 'station_j', 'pol_j', 'time']) -> merge_axes x 3 ('vis')
      -> romein(ngrid) -> fft(['v', 'u']) -> copy('system') -> on_image

Both build their blocks inside `block_scope(fuse=True)` where the spec's
`scope()` puts them (`fuse=True`, the default, as the spec's): the
fusion compiler (fuse.py) then runs the instrument's copy -> pfb,
correlate -> transpose and beamform -> transpose -> fdmt as one fused
group each, and the whole beam search, whose PFB ring has one reader,
as one group.  `fuse=False` builds the unfused topology.  The FRB
search stays unfused, as `frb_search_spec` builds no fuse scope.

The data-quality front end of the beam search (flag -> calibrate before
the B-engine) is built from blocks (`rfi_flag`, `gaincal`), as the JAX
package's benchmarks/dq_tpu.py builds it; it is not a spec of its own.
`ServiceSpec`/`Service`, supervision and UDP capture are not ported
yet.
"""

from __future__ import annotations

import contextlib
import threading
import time

import numpy as np
import torch

from . import views
from .blocks import (array_source, beamform, callback_sink, copy, correlate,
                     fdmt, fft, gather_sink, pfb, romein, transpose)
from .blocks import rfi_flag as _rfi_flag
from .ops.stats import mad_snr
from .pipeline import Pipeline, SinkBlock, block_scope


class FrameLedger(object):
    """Frame-continuity accounting for a service run.

    The terminal sink reports every gulp it consumes
    (`note_sink(seq, frame0, nframe)`).  Within one output sequence,
    committed frames must be CONTIGUOUS — a gap means committed data
    vanished (lost), an overlap means data was delivered twice
    (duplicated).  The invariant is lost == duplicated == 0.  The JAX
    ledger's restart and shed accounting comes with supervision, which is
    not ported yet.

    `first_sink_t` (time.perf_counter) and `first_sink_nframe` stamp the
    first committed gulp, so that a rate can be read without start-up.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self.first_sink_t = None
        self.first_sink_nframe = 0
        self.committed_frames = 0
        self.lost_frames = 0
        self.duplicated_frames = 0
        self.sequences = 0
        # seq key -> next expected frame0.  None = sequence announced
        # but no gulp observed yet: the first gulp baselines the
        # expectation at its own offset.
        self._expect = {}

    def note_sequence(self, key):
        with self._lock:
            self.sequences += 1
            self._expect[key] = None

    def note_sink(self, key, frame0, nframe):
        with self._lock:
            if self.first_sink_t is None:
                self.first_sink_t = time.perf_counter()
                self.first_sink_nframe = nframe
            expect = self._expect.get(key)
            if expect is not None:
                if frame0 > expect:
                    self.lost_frames += frame0 - expect
                elif frame0 < expect:
                    self.duplicated_frames += min(expect - frame0, nframe)
                self._expect[key] = max(expect, frame0 + nframe)
            else:
                self._expect[key] = frame0 + nframe
            self.committed_frames += nframe

    def summary(self):
        with self._lock:
            return {
                "committed_frames": self.committed_frames,
                "lost_frames": self.lost_frames,
                "duplicated_frames": self.duplicated_frames,
                "sequences": self.sequences,
            }



class CandidateDetectBlock(SinkBlock):
    """Terminal FRB candidate detector over the dedispersed (DM, time)
    stream: a per-DM-row median/MAD baseline over each gulp, and the
    gulp's peak SNR becomes a candidate when it crosses the threshold.

    The reduction runs on the span's device: the JAX block pulls each
    whole gulp to the host (service.py:731), this one copies back only
    the peak SNR and its flat index.  The JAX block's degraded-mode
    actuation (threshold raise, supervised gulp shedding) is not ported
    yet.
    `on_candidate(cand_dict)` fires per detection (an observer: its
    errors are swallowed).  `ledger` wires a FrameLedger.
    """

    MAX_CANDIDATES = 1024

    def __init__(self, iring, threshold=8.0, on_candidate=None, **kwargs):
        super().__init__(iring, **kwargs)
        self.threshold = float(threshold)
        self.on_candidate = on_candidate
        self.ledger = None
        self.candidates = []
        self.ncandidates = 0
        self.frames_seen = 0
        self.gulps_seen = 0
        self._seq_index = -1
        self._dm_scale = (0.0, 1.0)
        self._t_scale = (0.0, 1.0)

    def on_sequence(self, iseq):
        hdr = iseq.header
        tensor = hdr.get("_tensor", {})
        labels = tensor.get("labels") or []
        scales = tensor.get("scales") or []
        if "dispersion" in labels:
            self._dm_scale = tuple(scales[labels.index("dispersion")])
        if "time" in labels:
            self._t_scale = tuple(scales[labels.index("time")])
        self._seq_index += 1
        if self.ledger is not None:
            self.ledger.note_sequence(self._seq_index)

    def on_data(self, ispan):
        nframe = ispan.nframe
        frame0 = ispan.frame_offset
        if self.ledger is not None:
            self.ledger.note_sink(self._seq_index, frame0, nframe)
        self.frames_seen += nframe
        self.gulps_seen += 1
        x = ispan.data.to(torch.float32)
        if x.dim() == 1:
            x = x[None, :]
        x = x.reshape(-1, x.shape[-1])          # (ndm..., time) -> 2D
        if x.numel() == 0:
            return
        # Robust per-DM-row baseline (median + MAD, not mean/std: a bright
        # burst must not inflate its own baseline), ops/stats.py.
        snr = mad_snr(x, dim=-1)
        peak, flat = torch.stack([snr.max().double(),
                                  snr.argmax().double()]).cpu().tolist()
        if peak >= self.threshold:
            dm_i, t_i = divmod(int(flat), x.shape[1])
            dm0, ddm = self._dm_scale
            cand = {
                "seq": self._seq_index,
                "frame": int(frame0 + t_i),
                "dm_index": int(dm_i),
                "dm": dm0 + ddm * int(dm_i),
                "snr": round(peak, 3),
                "threshold": self.threshold,
            }
            self.ncandidates += 1
            self.candidates.append(cand)
            del self.candidates[:-self.MAX_CANDIDATES]
            cb = self.on_candidate
            if cb is not None:
                try:
                    cb(cand)
                except Exception:  # noqa: BLE001 — observer only
                    pass


def frb_search_pipeline(data, gulp_nframe, max_delay, f0_mhz=40.0,
                        df_mhz=0.00928, dt_s=1e-3, threshold=8.0,
                        device=None, fdmt_method=None, on_candidate=None,
                        gather=None, rfi_flag=None):
    """Build the FRB-search chain over `data`, a (time, freq) u8 array of
    filterbank power replayed from memory.  The axes are scaled as
    `frb_search_spec` scales them (the defaults are
    `lwa_frb_search_spec`'s LWA band: 40 MHz + nfreq x 9.28 kHz, 1 ms).

    `rfi_flag`: a dict of RfiFlagBlock parameters (e.g. dict(algo='mad',
    thresh=6.0, mad_factor=4.0, window=16)) inserts the RFI flagger
    (block "flag", gulp_nframe defaulting to the chain's) after the H2D
    copy and before the transpose, as `frb_search_spec(rfi_flag=...)`
    inserts it after capture.

    `device`: None runs on the card (raising where there is none);
    'cpu' runs every 'cuda'-space ring on the CPU.  `gather`: a list that
    receives every dedispersed gulp as numpy.  -> (pipeline, detector,
    ledger); call `pipeline.run()`."""
    data = np.asarray(data)
    pipe = Pipeline(device=device)
    ledger = FrameLedger()
    with pipe:
        src = array_source(data, gulp_nframe, header={
            "labels": ["time", "freq"],
            "scales": [[0.0, dt_s], [f0_mhz, df_mhz]],
            "units": ["s", "MHz"],
        }, name="capture")
        dev = copy(src, space="cuda", name="h2d")
        if rfi_flag is not None:
            params = dict(rfi_flag)
            params.setdefault("gulp_nframe", gulp_nframe)
            params.setdefault("name", "flag")
            dev = _rfi_flag(dev, **params)
        t = transpose(dev, ["freq", "time"], gulp_nframe=gulp_nframe,
                      name="transpose")
        d = fdmt(t, max_delay=max_delay, method=fdmt_method,
                 gulp_nframe=gulp_nframe, name="fdmt")
        det = CandidateDetectBlock(d, threshold=threshold,
                                   on_candidate=on_candidate,
                                   gulp_nframe=gulp_nframe, name="detect")
        det.ledger = ledger
        if gather is not None:
            gather_sink(d, gather, gulp_nframe=gulp_nframe, name="gather")
    return pipe, det, ledger


def default_beam_weights(nbeam, nsp):
    """`lwa_instrument_spec`'s deterministic small-integer beam weights
    (service.py:408-412): w[b, i] = ((b * nsp + i) % 7) - 3, complex64."""
    return ((np.arange(nbeam * nsp, dtype=np.int64).reshape(nbeam, nsp)
             % 7) - 3).astype(np.complex64)


def _lwa_gulp(gulp_nframe, nchan, n_int):
    gulp = int(gulp_nframe) if gulp_nframe else int(nchan)
    if gulp % nchan:
        raise ValueError(f"gulp_nframe ({gulp}) must be a multiple of "
                         f"nchan ({nchan}) so the PFB emits whole spectra "
                         f"per gulp")
    if gulp // nchan > n_int:
        raise ValueError(f"gulp_nframe/nchan ({gulp // nchan}) spectra per "
                         f"gulp exceeds nframe_per_integration ({n_int})")
    return gulp


def _fuse_scope(fuse):
    """`lwa_instrument_spec`'s scope(): `block_scope(fuse=True)` where
    the chains fuse, else no scope."""
    return block_scope(fuse=True) if fuse else contextlib.nullcontext()


def _lwa_fengine(voltages, gulp, nchan, ntap, coeffs, f0_mhz, dt_s,
                 pfb_method, fuse):
    """The replay source, the H2D copy and the PFB: the F-engine ring both
    engine branches read."""
    src = array_source(voltages, gulp, header={
        "dtype": "ci8",
        "labels": ["time", "station", "pol"],
        "scales": [[0.0, dt_s], None, None],
        "units": ["s", None, None],
        "cfreq": f0_mhz,
        "cfreq_units": "MHz",
    }, name="ingest")
    with _fuse_scope(fuse):
        dev = copy(src, space="cuda", name="fengine_h2d")
        return pfb(dev, nchan, ntap=ntap, coeffs=coeffs, method=pfb_method,
                   name="fengine_pfb")


def _lwa_bbranch(f, weights, n_int, max_delay, threshold, on_candidate,
                 ledger, gather, beamform_method, fdmt_method, fuse):
    """beamform -> transpose -> FDMT -> candidate detect."""
    with _fuse_scope(fuse):
        b = beamform(f, weights, nframe_per_integration=n_int,
                     method=beamform_method, name="bengine")
    with _fuse_scope(fuse):
        t = transpose(b, ["beam", "freq", "time"], name="bdetect_t")
        d = fdmt(t, max_delay=max_delay, method=fdmt_method,
                 name="bdetect_fdmt")
    det = CandidateDetectBlock(d, threshold=threshold,
                               on_candidate=on_candidate, name="bdetect")
    det.ledger = ledger
    if "beams" in gather:
        gather_sink(b, gather["beams"], name="gather_beams")
    if "dedispersed" in gather:
        gather_sink(d, gather["dedispersed"], name="gather_dedispersed")
    return det


def lwa_beam_search_pipeline(voltages, nstand=256, npol=2, nchan=4096,
                             ntap=4, n_int=16, nbeam=8, weights=None,
                             max_delay=64, threshold=8.0, f0_mhz=40.0,
                             dt_s=1e-6, gulp_nframe=None, coeffs=None,
                             device=None, pfb_method=None,
                             beamform_method=None, fdmt_method=None,
                             on_candidate=None, gather=None, fuse=True):
    """Build the LWA beam-search chain over `voltages`, ci8 [time,
    station, pol] replayed from memory: the JAX package's structured
    (re, im) array or its int8 storage form with a trailing axis of 2.
    The defaults are `lwa_instrument_spec`'s flagship geometry; `weights`
    ((nbeam, nstand*npol) complex) default to its small-integer planes,
    `coeffs` (the (ntap, nchan) PFB prototype) to `pfb_coeffs`.  A gulp
    is `gulp_nframe` voltage frames (default nchan), a multiple of nchan
    with at most n_int spectra.

    `device`: None runs on the card (raising where there is none); 'cpu'
    runs every 'cuda'-space ring on the CPU.  The three `*_method`
    arguments pin the PFB, beamform and FDMT methods (None reads their
    config flags).  `gather`: a dict whose 'beams' and 'dedispersed'
    lists, where present, receive the beam-power frames and the
    dedispersed gulps as numpy (a 'beams' reader is a second reader of
    the beamformer's ring, which then ends its fused group).  `fuse`:
    build the chain inside `block_scope(fuse=True)` as the spec does
    (module docstring).  -> (pipeline, detector, ledger); call
    `pipeline.run()`."""
    gulp = _lwa_gulp(gulp_nframe, nchan, n_int)
    if weights is None:
        weights = default_beam_weights(nbeam, int(nstand) * int(npol))
    pipe = Pipeline(device=device)
    ledger = FrameLedger()
    with pipe:
        f = _lwa_fengine(voltages, gulp, nchan, ntap, coeffs, f0_mhz, dt_s,
                         pfb_method, fuse)
        det = _lwa_bbranch(f, weights, n_int, max_delay, threshold,
                           on_candidate, ledger, gather or {},
                           beamform_method, fdmt_method, fuse)
    return pipe, det, ledger


def default_uvw(nstand, npol, ngrid, m=3):
    """`lwa_instrument_spec`'s default grid positions (service.py:
    414-423): stations on a square grid, each baseline's offset hashed
    onto the UV plane with room for an m x m kernel -> (2, nvis) int32,
    nvis = (nstand * npol)**2 in (i, j) order."""
    side = int(np.ceil(np.sqrt(nstand)))
    px = np.repeat(np.arange(nstand) % side, npol)
    py = np.repeat(np.arange(nstand) // side, npol)
    u = (px[None, :] - px[:, None] + side - 1).reshape(-1)
    v = (py[None, :] - py[:, None] + side - 1).reshape(-1)
    lo = max(int(ngrid) - m - 1, 1)
    return np.stack([(u * 7) % lo, (v * 7) % lo]).astype(np.int32)


def default_grid_kernel(m=3):
    """`lwa_instrument_spec`'s default gridding kernel (service.py:
    424-428): an (m, m) plane of ones, which broadcasts to every
    (channel, visibility) pair and is rank 1 (kernel K6b)."""
    return np.ones((m, m), np.complex64)


def lwa_instrument_pipeline(voltages, nstand=256, npol=2, nchan=4096,
                            ntap=4, n_int=16, nbeam=8, gulp_nframe=None,
                            engine="f32", gains=None, weights=None,
                            uvw=None, kernels=None, ngrid=128, max_delay=64,
                            threshold=8.0, f0_mhz=40.0, dt_s=1e-6,
                            on_image=None, on_candidate=None, coeffs=None,
                            device=None, pfb_method=None,
                            beamform_method=None, fdmt_method=None,
                            romein_method=None, fft_method=None,
                            gather=None, fuse=True):
    """Build the whole LWA instrument of `lwa_instrument_spec` over
    `voltages` (ci8 [time, station, pol], as `lwa_beam_search_pipeline`
    takes them): replay -> H2D -> PFB, then from the one PFB ring both
    the B branch (beamform -> transpose -> FDMT -> detect) and the X
    branch (correlate -> transpose -> merge_axes into 'vis' -> Romein
    grid -> FFT over (v, u) -> copy to the host -> `on_image`).

    Arguments as the spec's (minus its capture and interpret options):
    `fuse` builds the blocks inside `block_scope(fuse=True)` where the
    spec's scope() puts them, so that copy -> pfb, correlate -> image_t
    and bengine -> bdetect_t -> bdetect_fdmt fuse (the default, as the
    spec's); `gains` ((nstand[, npol]) complex) fold into the X-engine's
    voltages; `uvw` ((2, nvis) int grid positions) and `kernels`
    (broadcastable to (nchan, nvis, m, m)) default to `default_uvw` and
    `default_grid_kernel`; `weights` and `coeffs` as in
    `lwa_beam_search_pipeline`.  `engine='int8'` is not ported yet.
    `device`, the `*_method` pins and `gather` ('beams', 'dedispersed')
    as in `lwa_beam_search_pipeline`.  `on_image(grid)` gets each image
    frame, an (nchan, ngrid, ngrid, 1) host view valid during the call.

    Ring sizing: one X-engine frame is nchan * (nstand*npol)**2 complex64
    (8 GiB at the flagship), so the X-engine's output ring, the
    transpose's and the gridder's input hold one frame each
    (buffer_factor 1), and the imaging blocks take one frame per gulp.
    -> (pipeline, detector, ledger); call `pipeline.run()`."""
    if engine != "f32":
        raise NotImplementedError(
            f"lwa_instrument_pipeline: engine={engine!r} is not ported yet "
            f"(ROADMAP: the int8 X-engine); use engine='f32'")
    gulp = _lwa_gulp(gulp_nframe, nchan, n_int)
    nsp = int(nstand) * int(npol)
    if weights is None:
        weights = default_beam_weights(nbeam, nsp)
    m = 3 if kernels is None else int(np.shape(kernels)[-1])
    if uvw is None:
        uvw = default_uvw(nstand, npol, ngrid, m)
    if kernels is None:
        kernels = default_grid_kernel(m)
    pipe = Pipeline(device=device)
    ledger = FrameLedger()
    with pipe:
        f = _lwa_fengine(voltages, gulp, nchan, ntap, coeffs, f0_mhz, dt_s,
                         pfb_method, fuse)
        with _fuse_scope(fuse):
            x = correlate(f, n_int, engine=engine, gains=gains,
                          buffer_factor=1, name="xengine")
        with block_scope(gulp_nframe=1):
            with _fuse_scope(fuse):
                t = transpose(x, ["freq", "station_i", "pol_i", "station_j",
                                  "pol_j", "time"], buffer_factor=1,
                              name="image_t")
            v = views.merge_axes(t, "station_i", "pol_i", label="inp_i")
            v = views.merge_axes(v, "inp_i", "station_j", label="inp_ij")
            v = views.merge_axes(v, "inp_ij", "pol_j", label="vis")
            g = romein(v, ngrid, kernels, positions=uvw,
                       method=romein_method, buffer_factor=1,
                       name="image_grid")
            img = fft(g, axes=["v", "u"], axis_labels=["m", "l"],
                      method=fft_method, name="image_fft")
            host = copy(img, space="system", name="image_d2h")
            callback_sink(host, on_data=on_image, name="image_sink")
        det = _lwa_bbranch(f, weights, n_int, max_delay, threshold,
                           on_candidate, ledger, gather or {},
                           beamform_method, fdmt_method, fuse)
    return pipe, det, ledger
