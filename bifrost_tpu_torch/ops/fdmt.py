"""Fast Dispersion Measure Transform (counterpart of bifrost_tpu/ops/fdmt.py;
reference src/fdmt.cu, python/bifrost/fdmt.py).

Algorithm (Zackay & Ofek 2017, as the reference implements it): a tree of
log2(nchan) merge steps; at each step adjacent subbands merge, and each
output delay row r is ``out[r, t] = in[rowA, t] + in[rowB, t - delay]``
with per-row (rowA, rowB, delay) tables precomputed on the host.

The plan builder (`_partition_steps`, `_build_plan`, `plan_report`) is a
verbatim copy of the JAX package's, so both packages build identical
tables: one fused (rowA, rowB, delay) table per step, grouped into up to
three contiguous row-count buckets padded to 8 rows (`_MAX_BUCKETS`, the
JAX plan's default bucket budget).

Execution follows the JAX fast path (`Fdmt._exec_scan_fn`): the init
stage's shifted cumulative sums in the same order, as torch ops, then one
merge-step call per step.  A batched (batch, nchan, ntime) input (the
beam search's beams) runs as one block through every stage, one call per
merge step for all slices: the port's counterpart of the JAX package's
`vmap`.  Each step is launched over its own exact row count (the first
rows of its bucket's padded tables): the padding exists so that XLA
compiles few shapes, and a launch here takes any row count.  A step
reads only rows its predecessor wrote (the plan checks this), so rows
past a step's count are never read.  Methods:

- 'cuda' (what 'auto' resolves to): every merge step goes through
  `fdmt_kernel.merge_step`, which launches the hand-written kernel for a
  CUDA tensor and runs the plain version for a CPU tensor.  The state
  ping-pongs between two buffers, because rows read other rows.
- 'plain': the plain PyTorch merge step (gather + shift-add of the JAX
  scan body) on any device.
- 'naive': the per-channel init loop and unpadded per-step tables of the
  JAX unrolled executor, for tests.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .common import prepare, finalize
from .fdmt_kernel import merge_step, merge_step_plain
from .runtime import OpRuntime


def _pad8(rows):
    """Round a row count up to the 8-row f32 sublane tile (what both the
    XLA layout and the pallas kernel's row blocks want)."""
    return (int(rows) + 7) // 8 * 8


_MAX_BUCKETS = 3   # scan-chain budget of the bucketed layout


def _partition_steps(need):
    """Partition the merge steps into <= _MAX_BUCKETS CONTIGUOUS buckets
    minimizing the total padded row*step product plus boundary cost.

    ``need[s]`` is the exact row count step s must carry (max of its input
    and output state rows); a bucket spanning [i, j) pays
    ``(j - i) * _pad8(max(need[i:j]))`` of scan-body work, and every
    bucket after the first pays ONE extra virtual step at its own row
    count — the boundary cost of chaining another scan (the state
    slice/extend plus the while-loop carry copies are about one extra
    pass over the new bucket's state), measured to flip a marginal split
    from a win to a loss at the bench geometries.  So a split must save
    more than its own boundary traffic to be taken.  Exact DP over split
    points — S = log2(nchan) <= ~16, so O(S^2 * k) is host-side noise.
    Ties break toward FEWER buckets, so a geometry with nothing to trim
    degenerates to the single historical scan (k=1) rather than a
    gratuitous split.

    -> list of (start, stop) step ranges covering [0, len(need)).
    """
    S = len(need)
    if S == 0:
        return []
    kmax = min(_MAX_BUCKETS, S)
    pmax = {}
    for i in range(S):
        m = 0
        for j in range(i + 1, S + 1):
            m = max(m, need[j - 1])
            pmax[(i, j)] = _pad8(m)
    inf = float("inf")
    # dp[k][j] = min cost of the first j steps split into exactly k buckets
    dp = [[inf] * (S + 1) for _ in range(kmax + 1)]
    back = [[0] * (S + 1) for _ in range(kmax + 1)]
    dp[0][0] = 0
    for k in range(1, kmax + 1):
        for j in range(1, S + 1):
            for i in range(k - 1, j):
                steps = (j - i) + (1 if k > 1 else 0)   # + boundary pass
                c = dp[k - 1][i] + steps * pmax[(i, j)]
                if c < dp[k][j]:
                    dp[k][j] = c
                    back[k][j] = i
    kbest = min(range(1, kmax + 1), key=lambda k: (dp[k][S], k))
    bounds = []
    j = S
    for k in range(kbest, 0, -1):
        i = back[k][j]
        bounds.append((i, j))
        j = i
    return bounds[::-1]


class Fdmt(object):
    """Plan API mirroring the reference (fdmt.py:37-73):
    init(nchan, max_delay, f0, df, exponent), execute(idata, odata).

    ``method``: 'auto' (reads the `fdmt_method` config flag, else
    'cuda'), 'cuda', 'plain' or 'naive' (module docstring)."""

    def __init__(self):
        self.nchan = None
        self.max_delay = None
        self.f0 = None
        self.df = None
        self.exponent = -2.0
        self.method = "auto"
        self._steps = None       # fused per-step (rowA, rowB, delay) tables
        # (method, device) -> device tables, bounded LRU (ops/runtime.py)
        self._runtime = OpRuntime("fdmt", ("cuda", "plain", "naive"),
                                  config_flag="fdmt_method", default="cuda")

    # ------------------------------------------------------------------ plan
    def init(self, nchan, max_delay, f0, df, exponent=-2.0, method=None):
        self._set_geometry(nchan, max_delay, f0, df, exponent, method)
        self._build_plan()
        self._runtime.invalidate()
        return self

    def _set_geometry(self, nchan, max_delay, f0, df, exponent, method):
        self.nchan = int(nchan)
        self.max_delay = int(max_delay)
        self.f0 = float(f0)
        self.df = float(df)
        self.exponent = float(exponent)
        if method is not None:
            self.method = method
        if self.method not in ("auto", "cuda", "plain", "naive"):
            raise ValueError(f"unknown fdmt method {self.method!r}")


    def _rel_delay(self, flo, fhi):
        """Dispersion delay (in relative units) between flo and fhi."""
        e = self.exponent
        return flo ** e - fhi ** e

    def _build_plan(self):
        """Build FUSED per-step merge tables, mirroring fdmt.cu:339-436.

        State: a list of subbands, each with (f_start, nchan_sub, ndelay).
        Step 0 (init): each channel is its own subband with ndelay0 rows of
        cumulative sums along time.  Each later step merges adjacent subband
        pairs; each output row r in the merged band maps to
        (rowA in band0, rowB in band1, time delay d).  Per step the per-band
        tables are concatenated into one (rows,) triple so the executor
        issues ONE gather + ONE shifted add per step; band row counts are
        kept alongside (`_step_band_rows`) for the naive per-band executor.
        """
        nchan, f0, df = self.nchan, self.f0, self.df
        if df < 0:
            # negative-df bands are processed reversed (fdmt.cu:344-351)
            f0 = f0 + df * (nchan - 1)
            df = -df
            self._reversed = True
        else:
            self._reversed = False
        # total relative delay across the whole band, scaled so the full band
        # spans max_delay samples
        total_rel = self._rel_delay(f0, f0 + df * nchan)
        self._delay_scale = (self.max_delay - 1) / total_rel \
            if total_rel != 0 else 0.0

        def band_ndelay(fstart, nc):
            rel = self._rel_delay(fstart, fstart + df * nc)
            return max(1, int(round(abs(rel) * abs(self._delay_scale))) + 1)

        # initial subbands: one per channel
        bands = [(f0 + i * df, 1, band_ndelay(f0 + i * df, 1))
                 for i in range(nchan)]
        self._init_ndelay = [b[2] for b in bands]
        steps = []
        band_rows = []
        while len(bands) > 1:
            new_bands = []
            rowA_parts, rowB_parts, delay_parts, nd_parts = [], [], [], []
            row_off_in = np.cumsum([0] + [b[2] for b in bands])
            i = 0
            while i < len(bands):
                if i + 1 == len(bands):
                    # odd band carries through unchanged
                    fs, nc, nd = bands[i]
                    a = np.arange(nd, dtype=np.int64)
                    rowA_parts.append(row_off_in[i] + a)
                    rowB_parts.append(np.full(nd, -1, dtype=np.int64))
                    delay_parts.append(np.zeros(nd, dtype=np.int64))
                    nd_parts.append(nd)
                    new_bands.append((fs, nc, nd))
                    i += 1
                    continue
                (fsA, ncA, ndA), (fsB, ncB, ndB) = bands[i], bands[i + 1]
                nc = ncA + ncB
                nd = band_ndelay(fsA, nc)
                fmidA_hi = fsA + df * ncA  # boundary between the two bands
                relA = self._rel_delay(fsA, fmidA_hi)
                rel = self._rel_delay(fsA, fsA + df * nc)
                # split each output delay r between the two sub-bands in
                # proportion to their relative dispersion measure
                frac = relA / rel if rel != 0 else 0.5
                r = np.arange(nd, dtype=np.int64)
                dA = np.minimum(np.round(r * frac).astype(np.int64), ndA - 1)
                dB = np.minimum(r - dA, ndB - 1)
                rowA_parts.append(row_off_in[i] + dA)
                rowB_parts.append(row_off_in[i + 1] + dB)
                delay_parts.append(dA)
                nd_parts.append(nd)
                new_bands.append((fsA, nc, nd))
                i += 2
            steps.append((np.concatenate(rowA_parts),
                          np.concatenate(rowB_parts),
                          np.concatenate(delay_parts)))
            band_rows.append(nd_parts)
            bands = new_bands
        self._steps = steps
        self._step_band_rows = band_rows
        self._final_ndelay = bands[0][2]

        # ---- fast-path layout: init gather tables + padded stacked steps.
        init_nd = np.asarray(self._init_ndelay, dtype=np.int64)
        nd0max = int(init_nd.max())
        self._init_depth = nd0max
        # init rows are produced d-major (all channels still accumulating at
        # depth d, ascending channel); `_init_perm` gathers them back into
        # the chan-major order the step tables index.
        chans_by_d = [np.nonzero(init_nd > d)[0] for d in range(nd0max)]
        row_off = np.cumsum([0] + self._init_ndelay)
        perm = np.empty(int(init_nd.sum()), dtype=np.int64)
        pos = 0
        dmajor_index = {}
        for d, chans in enumerate(chans_by_d):
            for c in chans:
                dmajor_index[(int(c), d)] = pos
                pos += 1
        for c, nd in enumerate(self._init_ndelay):
            for d in range(nd):
                perm[row_off[c] + d] = dmajor_index[(c, d)]
        self._init_chans_by_d = chans_by_d
        self._init_perm = perm
        rows0 = len(perm)
        # ---- bucketed layout: each step s must carry max(input, output)
        # state rows; contiguous buckets share one padded row count (the
        # 8-row sublane tile) and one stacked table set per bucket.
        if steps:
            outs = [len(s[0]) for s in steps]
            ins = [rows0] + outs[:-1]
            need = [max(a, b) for a, b in zip(ins, outs)]
            bounds = _partition_steps(need)
            buckets = []
            for (i, j) in bounds:
                nr = _pad8(max(need[i:j]))
                n = j - i
                rowA = np.zeros((n, nr), dtype=np.int32)
                rowB = np.full((n, nr), -1, dtype=np.int32)
                delay = np.zeros((n, nr), dtype=np.int32)
                for s in range(i, j):
                    ra, rb, dl = steps[s]
                    rowA[s - i, :len(ra)] = ra
                    rowB[s - i, :len(rb)] = rb
                    delay[s - i, :len(dl)] = dl
                buckets.append({"start": i, "stop": j, "nrows": nr,
                                "tables": (rowA, rowB, delay),
                                "max_delay": int(delay.max())})
            self._buckets = buckets
            self._step_need = need
        else:
            self._buckets = []
            self._step_need = []

    def get_workspace_size(self, *args):
        """The caller's scratch an execute needs: none (the merge steps'
        state is the op's own)."""
        return 0

    def plan_report(self):
        """Padding accounting for the bucketed scan layout (host-side, no
        device work): the padded row*step product the executor actually
        pays, what the historical single scan would have paid, and the
        exact (unpadded) floor.  ``benchmarks/fdmt_tpu.py`` surfaces the
        waste percentages as ``fdmt_padding_waste_pct_before/after``."""
        need = self._step_need
        S = len(need)
        exact = sum(need)
        single = S * _pad8(max(need)) if need else 0
        bucketed = sum((b["stop"] - b["start"]) * b["nrows"]
                       for b in self._buckets)
        report = self._runtime.report()   # uniform op/method/origin/cache core
        report.update({
            "nchan": self.nchan, "max_delay": self.max_delay, "nsteps": S,
            "nbuckets": len(self._buckets),
            "bucket_steps": [b["stop"] - b["start"] for b in self._buckets],
            "bucket_nrows": [b["nrows"] for b in self._buckets],
            "bucket_max_delay": [b["max_delay"] for b in self._buckets],
            "rowsteps_exact": exact,
            "rowsteps_single": single,
            "rowsteps_bucketed": bucketed,
        })
        if exact > 0:
            report["padding_waste_pct_single"] = \
                100.0 * (single / exact - 1.0)
            report["padding_waste_pct_bucketed"] = \
                100.0 * (bucketed / exact - 1.0)
            report["rowsteps_reduction_pct"] = \
                100.0 * (1.0 - bucketed / single)
        else:
            report["padding_waste_pct_single"] = 0.0
            report["padding_waste_pct_bucketed"] = 0.0
            report["rowsteps_reduction_pct"] = 0.0
        return report

    def tables(self):
        """The plan's tables as numpy arrays, in the JAX plan's names
        (what `plan_from_reference` takes)."""
        return {"_steps": self._steps, "_buckets": self._buckets,
                "_init_perm": self._init_perm,
                "_init_chans_by_d": self._init_chans_by_d}

    # ------------------------------------------------------------- execution
    def _device_tables(self, method, device):
        """Plan tables on `device` (int32 for the kernel, int64 for the
        plain gathers), cached per (method, device).  'steps' holds, per
        merge step, its bucket's table rows cut to the step's exact row
        count."""
        def build():
            as_t = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt,
                                                 device=device)
            chans = [as_t(c, torch.int64) for c in self._init_chans_by_d]
            perm = as_t(self._init_perm, torch.int64)
            if method == "naive":
                steps = [tuple(as_t(t, torch.int64) for t in s)
                         for s in self._steps]
                return {"chans": chans, "perm": perm, "steps": steps}
            itype = torch.int32 if method == "cuda" else torch.int64
            steps = []
            nin = len(self._init_perm)
            for b in self._buckets:
                tables = tuple(as_t(t, itype) for t in b["tables"])
                for s in range(b["start"], b["stop"]):
                    n = len(self._steps[s][0])
                    rowA, rowB, delay = (t[s - b["start"], :n]
                                         for t in b["tables"])
                    # merge_step trusts its tables, and rows past the
                    # previous step's count hold stale data: every row a
                    # step reads must be one its predecessor wrote.
                    if n == 0 or int(rowA.min()) < 0 or \
                            int(delay.min()) < 0 or \
                            max(int(rowA.max()), int(rowB.max())) >= nin:
                        raise ValueError("fdmt plan: table row out of range")
                    steps.append(tuple(t[s - b["start"], :n]
                                       for t in tables))
                    nin = n
            return {"chans": chans, "perm": perm, "steps": steps}

        return self._runtime.plan((method, str(device)), build,
                                  method=method, origin="host")

    def _init_state(self, x, tabs, nrows):
        """The init stage (ops/fdmt.py:398-411) on a (batch, nchan,
        ntime) block: row (c, d) = sum over k <= d of x[..., c, t - k],
        one shifted add over the whole block per depth, gathered back to
        chan-major rows, zero-padded to `nrows` rows."""
        ntime = x.shape[-1]
        acc = x
        parts = [acc]
        for d in range(1, self._init_depth):
            shifted = F.pad(x[..., :ntime - d], (d, 0))
            acc = acc + shifted
            chans = tabs["chans"][d]
            parts.append(acc if len(chans) == self.nchan
                         else acc[..., chans, :])
        init = torch.cat(parts, dim=-2)[..., tabs["perm"], :] \
            if self._init_depth > 1 else parts[0]
        state = x.new_zeros(x.shape[:-2] + (nrows, ntime))
        state[..., :init.shape[-2], :] = init
        return state

    def _merge_steps(self, state, tabs, step):
        """Every merge step from the initial `state` ((batch,) rows x
        ntime, at least `max(_step_need)` rows), through `step`
        (`merge_step` or `merge_step_plain`), one call per step for the
        whole batch, ping-ponging between `state` and a second buffer;
        -> the final rows.  `state` is overwritten."""
        cur, other = state, torch.empty_like(state)
        for rowA, rowB, delay in tabs["steps"]:
            step(cur, rowA, rowB, delay,
                 out=other.narrow(-2, 0, rowA.shape[0]))
            cur, other = other, cur
        return cur[..., :self._final_ndelay, :]

    def _exec_scan(self, x, method):
        tabs = self._device_tables(method, x.device)
        cur = self._init_state(x, tabs, max([len(self._init_perm)] +
                                            self._step_need))
        step = merge_step if method == "cuda" else merge_step_plain
        return self._merge_steps(cur, tabs, step)

    def _exec_naive(self, x):
        """The JAX unrolled executor's arithmetic (ops/fdmt.py:449-503):
        per-channel init loop, unpadded per-step tables, and rows with no
        partner copied rather than added to zero."""
        tabs = self._device_tables("naive", x.device)
        ntime = x.shape[-1]
        rows = []
        for c, nd in enumerate(self._init_ndelay):
            prev = x[..., c, :]
            rows.append(prev)
            for d in range(1, nd):
                prev = prev + F.pad(x[..., c, :ntime - d], (d, 0))
                rows.append(prev)
        state = torch.stack(rows, dim=-2)
        t = torch.arange(ntime, device=x.device)[None, :]
        for rowA, rowB, delay in tabs["steps"]:
            a = state[..., rowA, :]
            b = state[..., rowB.clamp(min=0), :]
            src = t - delay[:, None]
            bs = torch.gather(b, -1, src.clamp(0, ntime - 1).expand(b.shape))
            bs = torch.where(src >= 0, bs, 0.0)
            state = torch.where((rowB >= 0)[:, None], a + bs, a)
        return state

    def _exec(self, x, method):
        """Dedisperse a (batch, nchan, ntime) f32 block, every slice in
        the same calls (the JAX package's vmap)."""
        if self._reversed:
            x = x.flip(-2)
        x = x.contiguous()
        if method == "naive":
            return self._exec_naive(x)
        return self._exec_scan(x, method)

    def execute(self, idata, odata=None, negative_delays=False):
        """Dedisperse `idata`, (nchan, ntime) or batched (batch, nchan,
        ntime), on its device; -> (min(ndelay, max_delay), ntime) f32,
        batched as the input."""
        x = prepare(idata)
        x = x.to(torch.float32)
        method = self._runtime.resolve_method(self.method)
        if negative_delays:
            # Negative sweeps are the time-mirror of positive ones.
            x = x.flip(-1)
        if x.dim() == 2:
            res = self._exec(x[None], method)[0]
        elif x.dim() == 3:   # batch axis first
            res = self._exec(x, method)
        else:
            raise ValueError(f"fdmt expects (nchan, ntime) or batched, "
                             f"got shape {tuple(x.shape)}")
        if negative_delays:
            res = res.flip(-1)
        if res.shape[-2] > self.max_delay:
            res = res[..., :self.max_delay, :]
        return finalize(res, out=odata)


def plan_from_reference(tables, nchan, max_delay, f0, df, exponent=-2.0,
                        method=None):
    """An Fdmt whose plan is carried over from the JAX package's: `tables`
    holds that plan's `_steps`, `_buckets`, `_init_perm` and
    `_init_chans_by_d` (numpy arrays, as `Fdmt.tables()` returns them);
    the geometry scalars are the plan's `init` arguments.  Nothing is
    rebuilt: the executor runs from the given tables."""
    plan = Fdmt()
    plan._set_geometry(nchan, max_delay, f0, df, exponent, method)
    plan._reversed = plan.df < 0
    steps = [tuple(np.asarray(t, dtype=np.int64) for t in s)
             for s in tables["_steps"]]
    chans_by_d = [np.asarray(c, dtype=np.int64)
                  for c in tables["_init_chans_by_d"]]
    perm = np.asarray(tables["_init_perm"], dtype=np.int64)
    plan._steps = steps
    plan._init_chans_by_d = chans_by_d
    plan._init_perm = perm
    plan._init_depth = len(chans_by_d)
    plan._init_ndelay = [sum(1 for c in chans_by_d if i in set(c.tolist()))
                         for i in range(plan.nchan)]
    plan._step_band_rows = [[len(s[0])] for s in steps]
    plan._final_ndelay = len(steps[-1][0]) if steps else len(perm)
    plan._buckets = [
        {"start": int(b["start"]), "stop": int(b["stop"]),
         "nrows": int(b["nrows"]),
         "tables": tuple(np.asarray(t, dtype=np.int32)
                         for t in b["tables"]),
         "max_delay": int(b["max_delay"])}
        for b in tables["_buckets"]]
    outs = [len(s[0]) for s in steps]
    ins = [len(perm)] + outs[:-1]
    plan._step_need = [max(a, b) for a, b in zip(ins, outs)]
    return plan
