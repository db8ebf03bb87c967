"""The service pieces of the port (counterpart of
bifrost_tpu/service.py): the `FrameLedger`, the `CandidateDetectBlock`,
and two chains built from the port's blocks, with an in-memory replay
source in place of UDP capture:

- `frb_search_pipeline`, the body of `frb_search_spec`
  (service.py:294-315):

      array_source (u8 [time, freq]) -> copy('cuda') ->
      transpose(['freq', 'time']) -> fdmt(max_delay) -> CandidateDetectBlock

- `lwa_beam_search_pipeline`, the B-engine branch of
  `lwa_instrument_spec` (service.py:443-534, its unfused form):

      array_source (ci8 [time, station, pol]) -> copy('cuda') ->
      pfb(nchan, ntap) -> beamform(weights, n_int) ->
      transpose(['beam', 'freq', 'time']) -> fdmt(max_delay) ->
      CandidateDetectBlock

`ServiceSpec`/`Service`, supervision, UDP capture, fusion and the
instrument's X/imaging branch are not ported yet.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from .blocks import (array_source, beamform, copy, fdmt, gather_sink, pfb,
                     transpose)
from .ops.stats import mad_snr
from .pipeline import Pipeline, SinkBlock


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
                        gather=None):
    """Build the FRB-search chain over `data`, a (time, freq) u8 array of
    filterbank power replayed from memory.  The axes are scaled as
    `frb_search_spec` scales them (the defaults are
    `lwa_frb_search_spec`'s LWA band: 40 MHz + nfreq x 9.28 kHz, 1 ms).

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


def lwa_beam_search_pipeline(voltages, nstand=256, npol=2, nchan=4096,
                             ntap=4, n_int=16, nbeam=8, weights=None,
                             max_delay=64, threshold=8.0, f0_mhz=40.0,
                             dt_s=1e-6, gulp_nframe=None, coeffs=None,
                             device=None, pfb_method=None,
                             beamform_method=None, fdmt_method=None,
                             on_candidate=None, gather=None):
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
    dedispersed gulps as numpy.  -> (pipeline, detector, ledger); call
    `pipeline.run()`."""
    nsp = int(nstand) * int(npol)
    gulp = int(gulp_nframe) if gulp_nframe else int(nchan)
    if gulp % nchan:
        raise ValueError(f"gulp_nframe ({gulp}) must be a multiple of "
                         f"nchan ({nchan}) so the PFB emits whole spectra "
                         f"per gulp")
    if gulp // nchan > n_int:
        raise ValueError(f"gulp_nframe/nchan ({gulp // nchan}) spectra per "
                         f"gulp exceeds nframe_per_integration ({n_int})")
    if weights is None:
        weights = default_beam_weights(nbeam, nsp)
    gather = gather or {}
    pipe = Pipeline(device=device)
    ledger = FrameLedger()
    with pipe:
        src = array_source(voltages, gulp, header={
            "dtype": "ci8",
            "labels": ["time", "station", "pol"],
            "scales": [[0.0, dt_s], None, None],
            "units": ["s", None, None],
            "cfreq": f0_mhz,
            "cfreq_units": "MHz",
        }, name="ingest")
        dev = copy(src, space="cuda", name="fengine_h2d")
        f = pfb(dev, nchan, ntap=ntap, coeffs=coeffs, method=pfb_method,
                name="fengine_pfb")
        b = beamform(f, weights, nframe_per_integration=n_int,
                     method=beamform_method, name="bengine")
        t = transpose(b, ["beam", "freq", "time"], name="bdetect_t")
        d = fdmt(t, max_delay=max_delay, method=fdmt_method,
                 name="bdetect_fdmt")
        det = CandidateDetectBlock(d, threshold=threshold,
                                   on_candidate=on_candidate,
                                   name="bdetect")
        det.ledger = ledger
        if "beams" in gather:
            gather_sink(b, gather["beams"], name="gather_beams")
        if "dedispersed" in gather:
            gather_sink(d, gather["dedispersed"], name="gather_dedispersed")
    return pipe, det, ledger
