"""Banded POA DP + backtrack walk, in node-id mode and in topo mode.

Counterpart of ``make_band_kernel`` in ``abpoa_tpu/ops/dp_pallas_band.py``
behind its two entries: ``band_poa_dp_packed`` (nid mode, the device
loop: planes and control words indexed by node id, the sweep order from
the packed i2n map, steps16 out) and ``band_poa_dp_batch`` (topo mode,
the round-based path: planes and control words indexed by topological
row, band state and rowmask as inputs, extend mode with z-drop, int64
step words out; ``steps16_compress`` where a caller reads the int16
stream). One CUDA source, ``csrc/band_dp.cu``, holds
both kernels over one row body; ``band_poa_dp_packed_ref`` and
``band_poa_dp_batch_ref`` are the plain PyTorch versions, batched over
instances, sharing one implementation (``_band_ref``).

A topo-mode launch on the card takes its inputs as one staged upload
(``TopoStage``: each export column of every instance in its narrow
dtype, one section each; ``stage_topo`` writes it on the host,
``band_poa_dp_staged`` copies it with one copy and launches the
prologue that widens it, then the band kernel). ``unstage_topo`` is the
plain version of that prologue.

What is computed, per instance: the adaptive-banded DP of one query
against the graph in topological order, with H/E1/E2 planes whose lane
l holds query column c = l (mod WB), a backtrack-bits plane that bakes
every comparison the reference walk makes (M -> D -> I order,
indel_first, cur_op gating; ref src/abpoa_align.c:64-170 via
``align/engine_np.py:636-935``), and the walk, which emits the step
stream and the misc row. A row whose band does not fit the WB window
sets M_OVFL; a walk with no move sets M_FAIL. The host rebuilds such
instances on the oracle.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..params import (GLOBAL_MODE, EXTEND_MODE, LINEAR_GAP, CONVEX_GAP,
                      SINK_NODE_ID)

from . import layout as L
from ._build import check_launch, library
from .steps import pack_steps, step_fields

I32 = torch.int32
RM_OK = 1 << 30


class BandConfig(NamedTuple):
    """Geometry and mode of the band kernel (the JAX ``BandConfig``
    without the TPU packing fields G and dv). ``nid`` selects node-id
    mode (the device loop; needs ``fresh`` and global mode); ``fresh``
    synthesises the post-sort band state (mpl = n_rows, mpr = 0) and an
    all-ones rowmask instead of reading them."""
    gap_mode: int
    pn: int
    R: int
    WB: int      # band tile width (multiple of pn)
    Wq: int      # padded query width (multiple of WB)
    P: int       # predecessor slots per row
    m: int
    bt_lmax: int  # walk length bound (step-stream capacity)
    align_mode: int = GLOBAL_MODE
    use_zdrop: bool = False
    fresh: bool = True
    nid: bool = True


class BandOut(NamedTuple):
    """The topo kernel's outputs as it writes them; the unpacked fields
    are computed where they are read."""
    bsn: torch.Tensor      # [B, R] beg_sn | end_sn<<16
    mplr: torch.Tensor     # [B, R] mpl | mpr<<16
    misc: torch.Tensor     # [B, M_NMISC]
    steps: torch.Tensor    # [B, max(bt_lmax, 8)] int64 op|row<<2|col<<32

    @property
    def beg_sn(self):
        return self.bsn & L.H16

    @property
    def end_sn(self):
        return self.bsn >> 16

    @property
    def mpl(self):
        return self.mplr & L.H16

    @property
    def mpr(self):
        return self.mplr >> 16

    @property
    def steps16(self):
        """[B, max(bt_lmax, 8)] int16 delta stream (``steps16_compress``)."""
        return steps16_compress(self.steps, self.misc)


def build_qpf(cfg: BandConfig, mat, qcodes: torch.Tensor) -> torch.Tensor:
    """Query-profile folds [..., m*(KW+1), WB]: fold k of base a holds
    mat[a, code(col)] for query columns [k*WB, (k+1)*WB); the last fold
    of each base is zeros. qcodes: [..., Wq]; mat: [m*m], or [..., m*m]
    with the leading axes of qcodes (one matrix per instance)."""
    m, WB = cfg.m, cfg.WB
    KW = cfg.Wq // WB
    lead = qcodes.shape[:-1]
    mat = torch.as_tensor(mat, dtype=I32, device=qcodes.device)
    mat = mat.reshape(*mat.shape[:-1], m, m)
    codes = qcodes.to(torch.int64)
    valid = codes < m
    idx = codes.clamp(max=m - 1)[..., None, :]
    if mat.dim() == 2:
        qp = mat[:, idx[..., 0, :]].movedim(0, -2)
    else:
        qp = mat.gather(-1, idx.expand(*lead, m, codes.shape[-1]))
    qp = torch.where(valid[..., None, :], qp,
                     torch.zeros((), dtype=I32, device=qcodes.device))
    qp = qp.reshape(*lead, m, KW, WB)
    qpf = torch.cat([qp, qp.new_zeros(*lead, m, 1, WB)], dim=-2)
    return qpf.reshape(*lead, m * (KW + 1), WB).contiguous()


# band lanes a block takes: two a thread up to 1024, four past them
# (``band_cpt``)
MAX_WB = 2048
# predecessor slots of topo mode; a backtrack pick field keeps 4 bits, and
# its 15 reads "slot 15 or later, or none": the walk re-tests slots 15..
# where it takes such a condition (``_band_ref``'s ``late_picks``)
MAX_P = 30
# a topo launch past FAN_P predecessor slots counts in ``fan_launches``
FAN_P = 16


def band_cpt(WB: int) -> int:
    """Band positions a thread of the kernel owns at WB lanes."""
    return 2 if WB <= 1024 else 4


def _check_geometry(cfg: BandConfig, name: str):
    if (cfg.WB % cfg.pn or cfg.Wq % cfg.WB or cfg.P % 2 or cfg.bt_lmax % 2
            or cfg.WB > MAX_WB or cfg.P > (16 if cfg.nid else MAX_P)):
        raise ValueError(f"{name}: bad geometry {cfg}")


def _check_tensors(name: str, want: dict, dev):
    for key, (t, shape) in want.items():
        if t.dtype != I32:
            raise TypeError(f"{name}: {key}: int32 expected, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {key}: shape {tuple(t.shape)} != "
                             f"{shape}")
        if t.device != dev:
            raise ValueError(f"{name}: {key}: on {t.device}, expected {dev}")
        if dev.type == "cuda" and not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


# dynamic shared memory a block of the band kernel may use on Hopper
MAX_SMEM_BYTES = L.MAX_SMEM_BYTES


def band_smem_bytes(nid: bool, R: int, P: int, WB: int) -> int:
    """Shared memory of one block: ctrl, (i2nn,) predecessor halves, band
    bounds and row maxima per row, the reductions' and scans' per-warp
    slots (227 words, whatever WB)."""
    return 4 * ((3 + int(nid) + P // 2) * R + 227)


def band_nplanes(gap_mode: int) -> int:
    """Planes of one instance: H and the backtrack bits, plus E1 (affine)
    and E2 (convex)."""
    return {LINEAR_GAP: 2, CONVEX_GAP: 4}.get(gap_mode, 3)


def _planes(cfg: BandConfig, B: int, dev):
    """Plane scratch: H, E1 (affine/convex), E2 (convex), backtrack bits."""
    nplanes = band_nplanes(cfg.gap_mode)
    planes = torch.empty(nplanes, B, cfg.R, cfg.WB, dtype=I32, device=dev)
    H, BT = planes[0], planes[-1]
    E1 = planes[1] if nplanes >= 3 else H
    E2 = planes[2] if nplanes == 4 else H
    return H, E1, E2, BT


# ------------------------------------------------------------------ #
# node-id mode: the device loop's entry

def band_poa_dp_packed(cfg: BandConfig, scal, ctrl, inp, i2nn, qpf,
                       misc_out=None, s16_out=None):
    """Batched DP + walk over the packed state. scal [B, >=S_NSCAL]
    (per-round slots from build_scal), ctrl [B, R], inp [B, R*P/2],
    i2nn [B, R], qpf [B, m*(KW+1), WB], all int32. Returns
    (misc [B, M_NMISC], s16w [B, LS/2]); entries of s16w past M_NSTEPS
    halves are zero. misc_out/s16_out, when given, receive the results.

    CUDA tensors launch ``csrc/band_dp.cu``; CPU tensors run the plain
    version. Nothing else: a kernel fault raises."""
    if not (cfg.nid and cfg.fresh and cfg.align_mode == GLOBAL_MODE):
        raise ValueError("band_poa_dp_packed: node-id mode is global and "
                         "fresh only")
    _check_geometry(cfg, "band_poa_dp_packed")
    scal = scal[:, :L.S_NSCAL].contiguous()
    B, R = ctrl.shape[0], cfg.R
    KW1 = cfg.Wq // cfg.WB + 1
    dev = ctrl.device
    _check_tensors("band_poa_dp_packed", {
        "scal": (scal, (B, L.S_NSCAL)), "ctrl": (ctrl, (B, R)),
        "inp": (inp, (B, R * cfg.P // 2)), "i2nn": (i2nn, (B, R)),
        "qpf": (qpf, (B, cfg.m * KW1, cfg.WB))}, dev)
    if dev.type == "cpu":
        misc, s16w = band_poa_dp_packed_ref(cfg, scal, ctrl, inp, i2nn, qpf)
        if misc_out is not None:
            misc_out.copy_(misc)
            s16_out.copy_(s16w)
            return misc_out, s16_out
        return misc, s16w
    if dev.type != "cuda":
        raise ValueError(f"band_poa_dp_packed: unsupported device {dev}")
    misc = (misc_out if misc_out is not None
            else torch.empty(B, L.M_NMISC, dtype=I32, device=dev))
    s16w = (s16_out if s16_out is not None
            else torch.empty(B, cfg.bt_lmax // 2, dtype=I32, device=dev))
    _check_tensors("band_poa_dp_packed", {
        "misc_out": (misc, (B, L.M_NMISC)),
        "s16_out": (s16w, (B, cfg.bt_lmax // 2))}, dev)
    s16w.zero_()
    H, E1, E2, BT = _planes(cfg, B, dev)
    lib = library("band_dp")
    with torch.cuda.device(dev):
        rc = lib.band_dp_launch(
            scal.data_ptr(), ctrl.data_ptr(), inp.data_ptr(),
            i2nn.data_ptr(), qpf.data_ptr(), misc.data_ptr(),
            s16w.data_ptr(), H.data_ptr(), E1.data_ptr(), E2.data_ptr(),
            BT.data_ptr(), B, cfg.R, cfg.WB, cfg.Wq, cfg.P, cfg.pn,
            cfg.gap_mode, cfg.bt_lmax,
            torch.cuda.current_stream(dev).cuda_stream)
    check_launch(rc, "band_dp")
    band_poa_dp_packed.launches += 1
    band_poa_dp_packed.wide_launches += int(band_cpt(cfg.WB) == 4)
    return misc, s16w


# launches of the kernel; of its instances of four positions a thread
# (bands past 1024 lanes)
band_poa_dp_packed.launches = 0
band_poa_dp_packed.wide_launches = 0


def band_poa_dp_packed_ref(cfg: BandConfig, scal, ctrl, inp, i2nn, qpf):
    """Plain PyTorch version of the node-id kernel (runs on any device):
    rows 1..n_rows-2 in the order of the i2n map, predecessor slots
    p < n_in(row). Returns (misc, s16w) like the kernel."""
    _, _, misc, s16w = _band_ref(cfg, scal, ctrl, inp, qpf, i2nn=i2nn)
    return misc, s16w


# ------------------------------------------------------------------ #
# topo mode: the round-based path's entry

def steps16_compress(st, misc):
    """The int16 delta stream of step words: i/j are non-increasing
    along the walk; a predecessor jump fits the 13-bit row decrement in
    graphs of at most 8192 rows (the split round's, at most 4096)."""
    op, iseq, jseq = (f.to(I32) for f in step_fields(st))
    prev_i = torch.cat([misc[:, L.M_BI:L.M_BI + 1], iseq[:, :-1]], 1)
    prev_j = torch.cat([misc[:, L.M_BJ:L.M_BJ + 1], jseq[:, :-1]], 1)
    s16 = (op | ((prev_j - jseq) << 2) | ((prev_i - iseq) << 3))
    return (((s16 & 0xFFFF) ^ 0x8000) - 0x8000).to(torch.int16)


def _pack_topo(cfg: BandConfig, scal, bases, pre_idx, pre_n, remain,
               qcodes, mpl0, mpr0, rowmask):
    """The kernel's int32 inputs from one round's export tuple:
    ctrl = base | pre_n<<5 | rowmask<<10 | remain<<16, predecessor rows
    packed two per word, the band state init mplr0 = mpl | mpr<<16 and
    the query-profile folds."""
    B, R, P = bases.shape[0], cfg.R, cfg.P
    scal = scal.to(I32)
    mat = scal[:, L.S_NSCAL:]
    scal = scal[:, :L.S_NSCAL].contiguous()
    rm = (1 << 10) if cfg.fresh else rowmask.to(I32) << 10
    ctrl = (bases.to(I32) | (pre_n.to(I32) << 5) | rm
            | (remain.to(I32) << 16))
    if pre_idx.dtype == torch.uint8:
        # delta encoding: pred = t - delta, invalid lanes 0
        pi = pre_idx.reshape(B, R, P).to(I32)
        tix = torch.arange(R, dtype=I32, device=pi.device)[None, :, None]
        pre2 = (tix - pi).clamp(min=0).reshape(B, R * P // 2, 2)
    else:
        pre2 = pre_idx.to(I32).reshape(B, R * P // 2, 2)
    pre = (pre2[:, :, 0] | (pre2[:, :, 1] << 16)).contiguous()
    if cfg.fresh:
        mplr0 = None
    else:
        mplr0 = (mpl0.to(I32) | (mpr0.to(I32) << 16)).contiguous()
    qpf = build_qpf(cfg, mat, qcodes.to(I32))
    return scal, ctrl.contiguous(), pre, mplr0, qpf


def _check_topo(cfg: BandConfig, name: str):
    if cfg.nid or cfg.align_mode not in (GLOBAL_MODE, EXTEND_MODE):
        raise ValueError(f"{name}: topo mode runs global or extend "
                         f"alignments only ({cfg})")
    _check_geometry(cfg, name)


# the staged layout: per section (name, index in the make_pallas_inputs
# tuple, dtype, columns of its [B, n]), widest dtype first, so that each
# section starts aligned to its dtype. rowmask, mpl and mpr only when not
# fresh; pre as int16 rows, or as uint8 deltas (pred = t - delta)
_NP32, _NP16, _NP8, _NPU8 = (np.dtype(t) for t in (np.int32, np.int16,
                                                    np.int8, np.uint8))


@functools.lru_cache(maxsize=256)
def _sections(cfg: BandConfig, delta: bool):
    R, P = cfg.R, cfg.P
    pre = ("pre", 2, _NPU8 if delta else _NP16, R * P)
    secs = [("scal", 0, _NP32, L.S_NSCAL + cfg.m * cfg.m)]
    secs += [] if delta else [pre]
    secs += [("pre_n", 3, _NP16, R), ("remain", 6, _NP16, R)]
    if not cfg.fresh:
        secs += [("mpl", 8, _NP16, R), ("mpr", 9, _NP16, R)]
    secs += [pre] if delta else []
    secs += [("bases", 1, _NP8, R), ("qcodes", 7, _NP8, cfg.Wq)]
    if not cfg.fresh:
        secs += [("rowmask", 10, _NP8, R)]
    return tuple(secs)


# the offsets the C entry takes, in its order (0: a section not staged)
_STAGE_ARGS = ("scal", "pre", "pre_n", "remain", "mpl", "mpr", "bases",
               "qcodes", "rowmask")


class TopoStage(NamedTuple):
    """Where one topo-mode launch's inputs lie in its staged bytes: the
    export columns of B instances (out_idx and out_n are not staged),
    each section [B, n] of one dtype at a byte offset (``_sections``)."""
    B: int
    delta: bool     # pre as uint8 deltas, else int16 rows
    offsets: dict   # section name -> byte offset
    nbytes: int


@functools.lru_cache(maxsize=256)
def topo_stage(cfg: BandConfig, B: int, delta: bool) -> TopoStage:
    """The staged layout of a launch of B instances (cached: a plan
    launches its geometry again and again). Its int16 sections
    hold rows, remain values and columns: R and Wq stay below 2^15 (B3's
    shared memory and ``band_refusal``'s query limit keep them there)."""
    if cfg.R >= 1 << 15 or cfg.Wq >= 1 << 15:
        raise ValueError(f"topo_stage: R {cfg.R} and Wq {cfg.Wq} must stay "
                         "below 2^15 (int16 sections)")
    offsets, off = {}, 0
    for name, _i, dt, n in _sections(cfg, delta):
        offsets[name] = off
        off += B * n * dt.itemsize
    return TopoStage(B, delta, offsets, off)


def stage_topo(cfg: BandConfig, st: TopoStage, arrs, out: np.ndarray):
    """Write the inputs of ``st.B`` instances into `out` (uint8, at least
    ``st.nbytes``): arrs[b] is instance b's ``make_pallas_inputs`` tuple
    of flat arrays (or its row of each stacked array). Each section is
    one copy; a column in another dtype is cast (wrapping) to the
    section's."""
    for name, i, dt, n in _sections(cfg, st.delta):
        if arrs[0][i].shape != (n,):
            raise ValueError(f"stage_topo: {name}: shape "
                             f"{arrs[0][i].shape}, expected ({n},)")
        off = st.offsets[name]
        np.concatenate([a[i] for a in arrs], casting="unsafe",
                       out=out[off:off + st.B * n * dt.itemsize].view(dt))


def _stage_tensors(cfg: BandConfig, cols):
    """The staged bytes of stacked input tensors (the 11-tuple of
    ``band_poa_dp_batch``) on their own device: (TopoStage, uint8
    tensor). The entry for inputs that are already on the card."""
    B = cols[1].shape[0]
    st = topo_stage(cfg, B, cols[2].dtype == torch.uint8)
    tdt = {np.dtype(np.int32): torch.int32, np.dtype(np.int16): torch.int16,
           np.dtype(np.int8): torch.int8, np.dtype(np.uint8): torch.uint8}
    parts = [cols[i].reshape(B, n).to(tdt[dt]).reshape(-1).view(torch.uint8)
             for _name, i, dt, n in _sections(cfg, st.delta)]
    return st, torch.cat(parts)


def unstage_topo(cfg: BandConfig, st: TopoStage, buf):
    """Plain version of the prologue (``csrc/band_dp.cu``
    ``topo_stage_kernel``): the kernel's int32 inputs from staged bytes
    (numpy uint8 or a CPU tensor). Returns (scal, ctrl, pre, mplr0,
    qpf) as ``_pack_topo`` does; mplr0 is None when fresh."""
    buf = np.asarray(buf)
    B, R, P, m, WB, Wq = st.B, cfg.R, cfg.P, cfg.m, cfg.WB, cfg.Wq
    i32 = np.int32

    def sec(name):
        _n, _i, dt, n = next(x for x in _sections(cfg, st.delta)
                             if x[0] == name)
        off = st.offsets[name]
        return buf[off:off + B * n * dt.itemsize].view(dt).reshape(B, n)
    full = sec("scal").astype(i32)
    scal = np.ascontiguousarray(full[:, :L.S_NSCAL])
    rm = i32(1) if cfg.fresh else sec("rowmask").astype(i32)
    ctrl = (sec("bases").astype(i32) | (sec("pre_n").astype(i32) << 5)
            | (rm << 10) | (sec("remain").astype(i32) << 16))
    pi = sec("pre").astype(i32).reshape(B, R, P)
    if st.delta:
        pi = np.maximum(np.arange(R, dtype=i32)[None, :, None] - pi, 0)
    pi = pi.reshape(B, R * P // 2, 2)
    pre = pi[:, :, 0] | (pi[:, :, 1] << 16)
    mplr0 = None if cfg.fresh else torch.from_numpy(
        sec("mpl").astype(i32) | (sec("mpr").astype(i32) << 16))
    KW = Wq // WB
    codes = sec("qcodes").astype(i32)
    valid = (codes >= 0) & (codes < m)
    mat = full[:, L.S_NSCAL:].reshape(B, m, m)
    qp = np.take_along_axis(
        mat, np.broadcast_to(np.where(valid, codes, 0)[:, None, :],
                             (B, m, Wq)), axis=2)
    qp = np.where(valid[:, None, :], qp, 0).reshape(B, m, KW, WB)
    qpf = np.concatenate([qp, np.zeros((B, m, 1, WB), i32)], axis=2)
    return (torch.from_numpy(scal), torch.from_numpy(ctrl),
            torch.from_numpy(np.ascontiguousarray(pre)), mplr0,
            torch.from_numpy(qpf.reshape(B, m * (KW + 1), WB)))


def topo_ws_words(cfg: BandConfig, B: int) -> int:
    """int32 words of the prologue's output on the card: scal, ctrl,
    predecessor halves, mplr0 and the query-profile folds (the same
    number as ``band_dp_topo_staged_launch`` lays out)."""
    KW1 = cfg.Wq // cfg.WB + 1
    return B * (L.S_NSCAL + 2 * cfg.R + cfg.R * cfg.P // 2
                + cfg.m * KW1 * cfg.WB)


def band_poa_dp_batch(cfg: BandConfig, scal, bases, pre_idx, pre_n,
                      out_idx, out_n, remain, qcodes, mpl0, mpr0, rowmask):
    """Batched banded DP + walk in topo space over one round's export
    tuple (``align/export.py`` ``make_pallas_inputs``, stacked over B,
    narrow dtypes fine). out_idx/out_n are unused (band state is pulled
    from predecessors); with ``cfg.fresh`` mpl0/mpr0/rowmask may be
    1-element dummies. Returns a ``BandOut``; misc slot M_LASTI is 0
    (node-id mode only). Rows at or past n_rows of beg/end_sn and
    mpl/mpr are not part of the result.

    CPU tensors run the plain version. CUDA tensors are staged on the
    card (``_stage_tensors``) and launch ``band_poa_dp_staged``; the
    batch path stages on the host instead (``stage_topo``)."""
    _check_topo(cfg, "band_poa_dp_batch")
    dev = bases.device
    if dev.type == "cpu":
        return band_poa_dp_batch_ref(cfg, scal, bases, pre_idx, pre_n,
                                     out_idx, out_n, remain, qcodes, mpl0,
                                     mpr0, rowmask)
    if dev.type != "cuda":
        raise ValueError(f"band_poa_dp_batch: unsupported device {dev}")
    cols = (scal, bases, pre_idx, pre_n, out_idx, out_n, remain, qcodes,
            mpl0, mpr0, rowmask)
    st, staged = _stage_tensors(cfg, cols)
    return band_poa_dp_staged(cfg, st, staged, dev)


def _align(n: int) -> int:
    return (n + 255) // 256 * 256


def band_poa_dp_staged(cfg: BandConfig, st: TopoStage, staged, dev):
    """The topo-mode DP + walk of ``st.B`` instances from their staged
    bytes (a uint8 tensor; on the card's path pinned host memory, copied
    to the card with one asynchronous copy on the current stream and
    counted in ``band_poa_dp_batch.uploads``, or already on the card).
    On the card: the copy, the prologue and the band kernel, enqueued by
    one call of the library. On the CPU: the plain prologue
    (``unstage_topo``) and the plain kernel. Returns a ``BandOut``. A
    staged host buffer must not be rewritten before the stream has
    passed the launch."""
    _check_topo(cfg, "band_poa_dp_staged")
    dev = torch.device(dev)
    B, R = st.B, cfg.R
    if dev.type == "cpu":
        scal, ctrl, pre, mplr0, qpf = unstage_topo(cfg, st, staged)
        return BandOut(*_band_ref(cfg, scal, ctrl, pre, qpf, mplr0=mplr0))
    if dev.type != "cuda":
        raise ValueError(f"band_poa_dp_staged: unsupported device {dev}")
    if staged.dtype != torch.uint8 or staged.numel() < st.nbytes:
        raise ValueError("band_poa_dp_staged: staged must be uint8 of at "
                         f"least {st.nbytes} bytes")
    upload = staged.device.type == "cpu"
    if not upload and staged.device != dev:
        raise ValueError(f"band_poa_dp_staged: staged on {staged.device}, "
                         f"expected {dev}")
    # one scratch allocation: the staged copy, the prologue's words and
    # the planes (H, E1 (affine/convex), E2 (convex), backtrack bits)
    plane = B * R * cfg.WB * 4
    nplanes = band_nplanes(cfg.gap_mode)
    o_ws = _align(st.nbytes) if upload else 0
    o_pl = o_ws + _align(topo_ws_words(cfg, B) * 4)
    scratch = torch.empty(o_pl + nplanes * plane, dtype=torch.uint8,
                          device=dev)
    base = scratch.data_ptr()
    H, BT = base + o_pl, base + o_pl + (nplanes - 1) * plane
    E1 = base + o_pl + plane if nplanes >= 3 else H
    E2 = base + o_pl + 2 * plane if nplanes == 4 else H
    bsn = torch.empty(B, R, dtype=I32, device=dev)
    mplr = torch.empty(B, R, dtype=I32, device=dev)
    misc = torch.empty(B, L.M_NMISC, dtype=I32, device=dev)
    steps = torch.empty(B, max(cfg.bt_lmax, 8), dtype=torch.int64,
                        device=dev)
    offs = [st.offsets.get(k, 0) for k in _STAGE_ARGS]
    with torch.cuda.device(dev):
        rc = library("band_dp").band_dp_topo_staged_launch(
            staged.data_ptr() if upload else None,
            base if upload else staged.data_ptr(), st.nbytes, base + o_ws,
            bsn.data_ptr(), mplr.data_ptr(), misc.data_ptr(),
            steps.data_ptr(), H, E1, E2, BT, *offs, B, R, cfg.WB, cfg.Wq,
            cfg.P, cfg.pn, cfg.gap_mode, cfg.bt_lmax, cfg.m, cfg.align_mode,
            int(cfg.use_zdrop), int(cfg.fresh), int(st.delta),
            torch.cuda.current_stream(dev).cuda_stream)
    check_launch(rc, "band_dp_topo")
    band_poa_dp_batch.uploads += int(upload)
    band_poa_dp_batch.launches += 1
    band_poa_dp_batch.wide_launches += int(band_cpt(cfg.WB) == 4)
    band_poa_dp_batch.fan_launches += int(cfg.P > FAN_P)
    return BandOut(bsn, mplr, misc, steps)


def fetch_bytes(B: int, cap: int, nmax: int) -> int:
    """Host bytes ``fetch_topo`` fills: misc, `cap` step words and `nmax`
    band-state words of B instances."""
    return B * (L.M_NMISC * 4 + cap * 8 + nmax * 4)


def fetch_topo(out: BandOut, cap: int, nmax: int, host=None, at=0):
    """What the host reads of a launch: misc, the first `cap` step words
    and the first `nmax` band-state words (mpl | mpr<<16) of each
    instance, as numpy arrays (misc [B, M_NMISC], steps [B, cap], mplr
    [B, nmax]). On the card: their copies into pinned host memory (the
    uint8 tensor `host` from byte `at`, ``fetch_bytes`` long, 8-aligned;
    by default a new buffer), enqueued on the current stream by one call
    of the library (no gather kernel); the arrays are views of it, to be
    read once the stream has passed this point. On the CPU: views of
    `out`."""
    misc, steps, mplr = out.misc, out.steps, out.mplr
    if misc.device.type == "cpu":
        return [misc.numpy(), steps[:, :cap].numpy(),
                mplr[:, :nmax].numpy()]
    B, R = mplr.shape
    if host is None:
        host = torch.empty(fetch_bytes(B, cap, nmax), dtype=torch.uint8,
                           pin_memory=True)
    rc = library("band_dp").band_dp_topo_fetch(
        host.data_ptr() + at, misc.data_ptr(), steps.data_ptr(),
        mplr.data_ptr(), B, R, steps.shape[1], cap, nmax,
        torch.cuda.current_stream(misc.device).cuda_stream)
    check_launch(rc, "band_dp_topo_fetch")
    o1 = at + B * L.M_NMISC * 4
    o2 = o1 + B * cap * 8
    h = host.numpy()
    return [h[at:o1].view(np.int32).reshape(B, L.M_NMISC),
            h[o1:o2].view(np.int64).reshape(B, cap),
            h[o2:o2 + B * nmax * 4].view(np.int32).reshape(B, nmax)]


# launches of the topo kernel; of its instances of four positions a thread
# (bands past 1024 lanes); of launches past 16 predecessor slots; the
# host-to-device copies of their inputs (one a launch staged on the host)
band_poa_dp_batch.launches = 0
band_poa_dp_batch.wide_launches = 0
band_poa_dp_batch.fan_launches = 0
band_poa_dp_batch.uploads = 0


def band_poa_dp_batch_ref(cfg: BandConfig, scal, bases, pre_idx, pre_n,
                          out_idx, out_n, remain, qcodes, mpl0, mpr0,
                          rowmask):
    """Plain PyTorch version of ``band_poa_dp_batch`` (runs on any
    device; same inputs, same ``BandOut``)."""
    _check_topo(cfg, "band_poa_dp_batch_ref")
    scal_, ctrl, pre, mplr0, qpf = _pack_topo(
        cfg, scal, bases, pre_idx, pre_n, remain, qcodes, mpl0, mpr0,
        rowmask)
    return BandOut(*_band_ref(cfg, scal_, ctrl, pre, qpf, mplr0=mplr0))


# ------------------------------------------------------------------ #
# plain PyTorch version of both kernels

def _band_ref(cfg: BandConfig, scal, ctrl, pre, qpf, i2nn=None,
              mplr0=None):
    """Batched over B, per instance the same function as the kernels.
    Node-id mode when i2nn is given (rows in i2n order, ctrl =
    base|n_out<<3|n_al<<7|n_in<<10|remain<<16), else topo mode (row t is
    topo index t, ctrl = base|pre_n<<5|rowmask<<10|remain<<16; mplr0 the
    band state init, None when fresh). Rows outside an instance's sweep
    write a scratch row R. Returns (bsn [B, R], mplr [B, R], misc, out)
    with out the steps16 words [B, LS/2] in node-id mode and the int32
    steps [B, max(LS, 8)] in topo mode."""
    nid = i2nn is not None
    dev = ctrl.device
    B, R, WB, pn, P = ctrl.shape[0], cfg.R, cfg.WB, cfg.pn, cfg.P
    gm = cfg.gap_mode
    m = cfg.m
    extend = cfg.align_mode == EXTEND_MODE
    P2 = P // 2
    NSEG = WB // pn
    KW1 = cfg.Wq // WB + 1
    LS = cfg.bt_lmax

    def full(v):
        return torch.full((B,), v, dtype=I32, device=dev)

    bidx = torch.arange(B, device=dev)
    lane = torch.arange(WB, dtype=I32, device=dev)[None, :]
    NEGt = torch.tensor(L.NEG, dtype=I32, device=dev)
    zero = torch.zeros((), dtype=I32, device=dev)

    scal = scal.to(I32)
    inf = scal[:, L.S_INF]
    infc = inf[:, None]
    qlen = scal[:, L.S_QLEN]
    qlenc = qlen[:, None]
    nrows = scal[:, L.S_NROWS]
    w = scal[:, L.S_W]
    remend = scal[:, L.S_REMEND]
    dpsn = scal[:, L.S_DPSN]
    dpsnc = dpsn[:, None]
    e1, o1, oe1, e2, o2, oe2, zdrop = (
        int(v) for v in scal[0, L.S_E1:L.S_ZDROP + 1].tolist()) \
        if B else (0,) * 7
    pre3 = pre.reshape(B, R, P2)

    def preds_of(node):
        """[B, P] predecessor rows of row `node` [B] (clamped to R-1)."""
        wv = pre3[bidx, node.long()]
        pr = torch.stack([wv & 0xFFFF, (wv >> 16) & 0xFFFF], dim=2)
        return pr.reshape(B, P).clamp(max=R - 1)

    # one scratch row (R) takes the writes of rows outside a sweep
    H = torch.zeros(B, R + 1, WB, dtype=I32, device=dev)
    E1 = torch.zeros_like(H) if gm != LINEAR_GAP else None
    E2 = torch.zeros_like(H) if gm == CONVEX_GAP else None
    BT = torch.zeros_like(H)
    bsn = torch.zeros(B, R + 1, dtype=I32, device=dev)
    rms = torch.zeros(B, R + 1, dtype=I32, device=dev)
    mplr = torch.zeros(B, R + 1, dtype=I32, device=dev)

    # ---- first row (ref :553-662): lane l holds col l ----
    rms[:, 0] = RM_OK | 1
    rem0 = (ctrl[:, 0] >> 16) - remend - 1
    end0 = torch.minimum(qlen, (qlen - rem0).clamp(min=0) + w)
    end_sn0 = end0 // pn
    bsn[:, 0] = end_sn0 << 16
    cap0 = torch.minimum(end_sn0 + 1, dpsn - 1)
    ovfl = cap0 + 2 > NSEG
    hi_mask = (lane // pn) <= cap0[:, None]
    de_mask = lane <= ((end_sn0 + 1) * pn - 1)[:, None]
    fill0 = torch.where(hi_mask, infc, zero)
    if gm == LINEAR_GAP:
        H[:, 0] = torch.where(de_mask, -e1 * lane, fill0)
    else:
        hv = -o1 - e1 * lane
        if gm == CONVEX_GAP:
            hv = torch.maximum(hv, -o2 - e2 * lane)
        h0 = torch.where(de_mask & (lane >= 1), hv, fill0)
        H[:, 0] = torch.where(lane == 0, zero, h0)
        E1[:, 0] = torch.where(lane == 0, torch.tensor(-oe1, dtype=I32,
                                                       device=dev), fill0)
        if gm == CONVEX_GAP:
            E2[:, 0] = torch.where(lane == 0, torch.tensor(
                -oe2, dtype=I32, device=dev), fill0)

    cells = full(0)
    p_iota = torch.arange(P, dtype=I32, device=dev)[None, :]
    limit = torch.minimum(nrows - 1, full(R - 1))
    tmax = int(limit.max()) if B else 0
    stop = torch.zeros(B, dtype=torch.bool, device=dev)
    bs = inf.clone()
    bi = full(0)
    bj = full(0)
    brem = ctrl[:, 0] >> 16

    def pull(preds, npre, iw):
        """Band state of a row from its predecessors' row maxima."""
        pvs = p_iota < npre[:, None]
        wr = rms.gather(1, preds.long())
        ok = pvs & (wr >= RM_OK)
        v = wr & (RM_OK - 1)
        mpl = torch.where(ok, v, 1 << 29).amin(1)
        mpr = torch.where(ok, v, -(1 << 29)).amax(1)
        has_src = (pvs & (preds == 0)).any(1)
        mpl = torch.minimum(mpl, torch.where(has_src, 1 << 29, iw & 0xFFFF))
        mpr = torch.maximum(mpr, torch.where(has_src, -(1 << 29), iw >> 16))
        return mpl, mpr

    def to_rel(x, lane_of_rel):
        return x.gather(1, lane_of_rel)

    def prefmax(gv_rel):
        return torch.cummax(gv_rel, dim=1).values

    for t in range(1, tmax):
        inr = t < limit
        if nid:
            # rows past an instance's sweep read the SINK row's control
            row = torch.where(inr, (i2nn[:, t] & 0xFFFF).clamp(0, R - 1),
                              SINK_NODE_ID)
        else:
            row = full(t)
        rid = torch.where(inr, row, R)
        ridl = rid.long()
        cw = ctrl[bidx, row.long()]
        if nid:
            npre = (cw >> 10) & 15
            active = inr
            iw = nrows
        else:
            npre = (cw >> 5) & 31
            active = inr & (((cw >> 10) & 1) > 0) & ~stop
            iw = nrows if mplr0 is None else mplr0[:, t]
        preds = preds_of(row)                                  # [B, P]
        pvs = p_iota < npre[:, None]
        predl = preds.long()
        bsnp = bsn.gather(1, predl)
        min_pb = torch.where(pvs, bsnp & 0xFFFF, RM_OK).amin(1)
        mpl, mpr = pull(preds, npre, iw)
        if not nid:
            mplr[bidx, ridl] = mpl | (mpr << 16)
        rem = (cw >> 16) - remend - 1
        beg = (torch.minimum(mpl, qlen - rem) - w).clamp(min=0)
        end = torch.minimum(qlen, torch.maximum(mpr, qlen - rem) + w)
        beg_sn = torch.maximum(beg // pn, min_pb)
        end_sn = end // pn
        bsn[bidx, ridl] = beg_sn | (end_sn << 16)
        cells = cells + torch.where(active, (end_sn - beg_sn + 1) * pn, 0)
        capg = torch.minimum(end_sn + 1, dpsn - 1)
        ovfl = ovfl | (active & (capg - beg_sn + 2 > NSEG))
        lo_g = beg_sn * pn
        k0 = lo_g // WB
        # the kernel stages beg|end<<10|lomod<<20 in one word
        bel = (beg_sn | (end_sn << 10) | ((lo_g - k0 * WB) << 20))[:, None]
        base = (cw & (7 if nid else 31)).long()
        fold = (base * KW1 + k0).clamp(0, m * KW1 - 2)
        qA = qpf[bidx, fold]
        qB = qpf[bidx, fold + 1]
        bval = (base < m)[:, None]
        lomodc = bel >> 20
        qwin = torch.where(bval, torch.where(lane >= lomodc, qA, qB), zero)
        begc = bel & 1023
        endc = (bel >> 10) & 1023
        capc = torch.minimum(endc + 1, dpsnc - 1)
        dlo = lane - lomodc
        rel = torch.where(dlo >= 0, dlo, dlo + WB)
        lane_of_rel = (lomodc + lane) % WB
        lane_of_rel = lane_of_rel.long()
        # rel is in [0, WB) on every swept row; a row with no valid
        # predecessor (padding, unreachable) has a garbage band whose rel
        # is only wrapped back into range for indexing
        rell = (rel % WB).long()
        c = begc * pn + rel
        seg = c // pn
        band = (seg >= begc) & (seg <= endc)
        qrow = torch.where((c >= 1) & (c <= qlenc), qwin, zero)

        # ---- predecessor merges ----
        btp = []
        hacc = e1acc = e2acc = None
        for p in range(max(1, int(npre.max()))):
            pred = predl[:, p]
            pv = pvs[:, p][:, None]
            pw = bsn[bidx, pred]
            pbel = ((pw & 0xFFFF) | ((pw >> 16) << 10)
                    | (pvs[:, p].to(I32) << 20))[:, None]
            pvc = (pbel >> 20) > 0
            pbegc = torch.where(pvc, pbel & 1023, 1 << 29)
            pendc = torch.where(pvc, (pbel >> 10) & 1023, -(1 << 29))
            _begc = torch.maximum(begc, pbegc)
            _endc = torch.minimum(torch.minimum(pendc + 1, endc), dpsnc - 1)
            preH = H[bidx, pred]
            rollH = torch.roll(preH, 1, dims=1)
            cand = torch.where(c == 0, NEGt, rollH)
            boundary = torch.where(pbegc < begc, cand, infc)
            cand = torch.where(c == _begc * pn, boundary, cand)
            if gm == LINEAR_GAP:
                cand = torch.maximum(cand + qrow, preH - e1)
            mmask = (seg >= _begc) & (seg <= _endc) & pvc
            plo = pbegc * pn
            phi = (pendc + 1) * pn - 1
            m_in = pvc & (c - 1 >= plo) & (c - 1 <= phi)
            okp = pvc & (c >= plo) & (c <= phi)
            preE1 = E1[bidx, pred] if gm != LINEAR_GAP else None
            preE2 = E2[bidx, pred] if gm == CONVEX_GAP else None
            btp.append((pv, torch.where(m_in, rollH, NEGt),
                        torch.where(okp, preH, NEGt),
                        torch.where(okp, preE1, NEGt) if preE1 is not None
                        else None,
                        torch.where(okp, preE2, NEGt) if preE2 is not None
                        else None))
            if p == 0:
                fill = (((seg >= begc) & (seg < _begc))
                        | ((seg > _endc) & (seg <= capc)))
                hacc = torch.where(mmask, cand,
                                   torch.where(fill, infc, zero))
            else:
                hacc = torch.where(mmask, torch.maximum(hacc, cand), hacc)
            if gm != LINEAR_GAP:
                _ende = torch.minimum(pendc, endc)
                emask = (seg >= _begc) & (seg <= _ende) & pvc
                if p == 0:
                    efill = (((seg >= begc) & (seg < _begc))
                             | ((seg > _ende) & (seg <= endc)))
                    ef = torch.where(efill, infc, zero)
                    e1acc = torch.where(emask, preE1, ef)
                    if gm == CONVEX_GAP:
                        e2acc = torch.where(emask, preE2, ef)
                else:
                    e1acc = torch.where(emask, torch.maximum(e1acc, preE1),
                                        e1acc)
                    if gm == CONVEX_GAP:
                        e2acc = torch.where(
                            emask, torch.maximum(e2acc, preE2), e2acc)
        h = hacc
        e1v = e1acc if gm != LINEAR_GAP else h
        e2v = e2acc if gm == CONVEX_GAP else h
        relz = rel == 0

        def f_scan(src, e, oe, seed):
            gv = torch.where(band, torch.maximum(src, infc) + rel * e, NEGt)
            cm = prefmax(to_rel(gv, lane_of_rel))
            # running max up to rel-1, NEG at rel 0
            Pm = torch.cat([NEGt.expand(B, 1), cm[:, :-1]], 1).gather(1, rell)
            F = Pm - oe - (rel - 1) * e
            F = torch.where(relz, seed - oe, F)
            return torch.maximum(F, infc)

        if gm == LINEAR_GAP:
            gv = torch.where(band, torch.maximum(h, infc) + rel * e1, NEGt)
            hfin = torch.maximum(
                prefmax(to_rel(gv, lane_of_rel)).gather(1, rell) - rel * e1,
                infc)
            hrow = torch.where(band, hfin, h)
        else:
            h0 = h + torch.where(band, qrow, zero)
            seed = h0.gather(1, lomodc.clamp(0, WB - 1).long())
            if gm == CONVEX_GAP:
                hpf = torch.maximum(torch.maximum(h0, e1v), e2v)
                hpf = torch.where(band, hpf, NEGt)
                f1 = f_scan(hpf, e1, oe1, seed)
                f2 = f_scan(hpf, e2, oe2, seed)
                hh = torch.maximum(torch.maximum(hpf, f1), f2)
                e1row = torch.where(band, torch.maximum(e1v - e1, hh - oe1),
                                    e1v)
                e2row = torch.where(band, torch.maximum(e2v - e2, hh - oe2),
                                    e2v)
                f2row = torch.where(band, f2, zero)
            else:
                f1 = f_scan(torch.where(band, h0, NEGt), e1, oe1, seed)
                h1 = torch.maximum(h0, e1v)
                hh = torch.maximum(h1, f1)
                e1n = torch.maximum(e1v - e1, hh - oe1)
                e1row = torch.where(band, torch.where(hh == h1, e1n, infc),
                                    e1v)
            hrow = torch.where(band, hh, h0)
            f1row = torch.where(band, f1, zero)
        H[bidx, ridl] = hrow
        if gm != LINEAR_GAP:
            E1[bidx, ridl] = e1row
        if gm == CONVEX_GAP:
            E2[bidx, ridl] = e2row

        # ---- backtrack bits: [0:4] m_pick, [4:8] e1_pickM,
        # [8:12] e1_pickX, [12] e1_openM, [13] e1_openX, [14:18] e2_pickM,
        # [18:22] e2_pickX, [22] e2_openM, [23] e2_openX, [24] f1_open
        # (linear: f_possible), [25] f1_ext, [26] f1_gate, [27] f2_open,
        # [28] f2_ext, [29] f2_gate; a pick holds slots 0-14, 15 = slot 15
        # or later, or none (the walk's late_picks) ----
        one = torch.ones((), dtype=I32, device=dev)
        fifteen = torch.full((), 15, dtype=I32, device=dev)
        acc = None
        for p, (pv, bm, bh, be1, be2) in enumerate(btp[:15]):
            mh = (bm + qrow) == hrow
            if gm == LINEAR_GAP:
                e1m = e1x = (bh - e1) == hrow
                e1o = torch.zeros_like(mh)
                e2m = e2x = e2o = e1o
            else:
                e1m = hrow == be1
                e1x = e1row == (be1 - e1)
                e1o = (bh - oe1) == be1
                if gm == CONVEX_GAP:
                    e2m = hrow == be2
                    e2x = e2row == (be2 - e2)
                    e2o = (bh - oe2) == be2
                else:
                    e2m = e2x = e2o = torch.zeros_like(mh)
            if p == 0:
                acc = [torch.where(mh, zero, fifteen),
                       torch.where(e1m, zero, fifteen),
                       torch.where(e1x, zero, fifteen),
                       (e1m & e1o).to(I32), (e1x & e1o).to(I32),
                       torch.where(e2m, zero, fifteen),
                       torch.where(e2x, zero, fifteen),
                       (e2m & e2o).to(I32), (e2x & e2o).to(I32)]
                continue
            pt = torch.tensor(p, dtype=I32, device=dev)
            u = pv & mh & (acc[0] == 15)
            acc[0] = torch.where(u, pt, acc[0])
            for kp, ko, hit, op_ in ((1, 3, e1m, e1o), (2, 4, e1x, e1o),
                                     (5, 7, e2m, e2o), (6, 8, e2x, e2o)):
                if kp >= 5 and gm != CONVEX_GAP:
                    continue
                u = pv & hit & (acc[kp] == 15)
                acc[ko] = torch.where(u & op_, one,
                                      torch.where(u, zero, acc[ko]))
                acc[kp] = torch.where(u, pt, acc[kp])
        hprev = torch.where(relz, zero, torch.roll(hrow, 1, dims=1))
        if gm == LINEAR_GAP:
            fb = ((hprev - e1) == hrow).to(I32) << 24
        else:
            f1prev = torch.where(relz, zero, torch.roll(f1row, 1, dims=1))
            fb = ((((hprev - oe1) == f1row).to(I32) << 24)
                  | (((f1prev - e1) == f1row).to(I32) << 25)
                  | ((hrow == f1row).to(I32) << 26))
            if gm == CONVEX_GAP:
                f2prev = torch.where(relz, zero,
                                     torch.roll(f2row, 1, dims=1))
                fb = (fb | (((hprev - oe2) == f2row).to(I32) << 27)
                      | (((f2prev - e2) == f2row).to(I32) << 28)
                      | ((hrow == f2row).to(I32) << 29))
        BT[bidx, ridl] = (acc[0] | (acc[1] << 4) | (acc[2] << 8)
                          | (acc[3] << 12) | (acc[4] << 13)
                          | (acc[5] << 14) | (acc[6] << 18)
                          | (acc[7] << 22) | (acc[8] << 23) | fb)

        # ---- row max with the reference tie-breaks: among the maximal
        # in-band cells, the lowest lane-in-segment, then the last
        # segment, then the first (the lane above 17 bits of segment
        # order: the JAX kernel's 15 overflow from band segment 31 on) ----
        lseg = seg - begc
        nseg = endc - begc + 1
        vv = torch.where(band & (c <= qlenc), hrow, infc)
        prio = torch.where(lseg == nseg - 1, -1, lseg)
        key = (rel % pn) * (1 << 17) + (prio * 1024 + lseg + 1024)
        gmax = vv.amax(1, keepdim=True)
        kpick = torch.where(vv == gmax, key, 1 << 30).amin(1, keepdim=True)
        aux_pick = (kpick & 0x1FFFF) - 1024
        wseg = aux_pick - (aux_pick // 1024) * 1024
        maxi = torch.where(gmax > infc, (begc + wseg) * pn + (kpick >> 17),
                           -1)[:, 0]
        stop_now = torch.zeros_like(stop)
        if extend:
            mx = gmax[:, 0]
            better = mx > bs
            if cfg.use_zdrop:
                delta = brem - (cw >> 16)
                zlim = zdrop + e1 * (delta - (maxi - bj)).abs()
                stop_now = ~better & (bs - mx > zlim)
            take = active & better
            bs = torch.where(take, mx, bs)
            bi = torch.where(take, t, bi)
            bj = torch.where(take, maxi, bj)
            brem = torch.where(take, cw >> 16, brem)
            stop_now = active & stop_now
            stop = stop | stop_now
        # successors pull this row's max position
        rms[bidx, ridl] = torch.where(active & ~stop_now,
                                      RM_OK | (maxi + 1), 0)

    n2i_of = i2nn >> 16 if nid else None
    if not nid:
        # the sink row is never swept: pin its bsn and pull its band state
        bsn[bidx, limit.long()] = 0
        preds = preds_of(limit)
        iw = nrows if mplr0 is None else mplr0[bidx, limit.long()]
        mpl, mpr = pull(preds, (ctrl[bidx, limit.long()] >> 5) & 31, iw)
        mplr[bidx, limit.long()] = mpl | (mpr << 16)

    if cfg.align_mode == GLOBAL_MODE:
        # ---- best cell over the sink's predecessors ----
        if nid:
            sink = full(SINK_NODE_ID)
            npre_sink = (ctrl[:, SINK_NODE_ID] >> 10) & 15
        else:
            sink = (nrows - 1).clamp(0, R - 1)
            npre_sink = (ctrl[bidx, sink.long()] >> 5) & 31
        spreds = preds_of(sink)
        for p in range(P):
            pv = p < npre_sink
            pred = spreds[:, p].long()
            pw = bsn[bidx, pred]
            ec = torch.minimum(qlen, ((pw >> 16) + 1) * pn - 1)
            lo_p = (pw & 0xFFFF) * pn
            ln = (ec % WB).long()
            val = H[bidx, pred, ln]
            val = torch.where((ec >= lo_p) & (ec < lo_p + WB), val, 0)
            better = pv & (val > bs)
            bs = torch.where(better, val, bs)
            bi = torch.where(better, spreds[:, p], bi)
            bj = torch.where(better, ec, bj)
    misc = torch.zeros(B, L.M_NMISC, dtype=I32, device=dev)
    misc[:, L.M_BEST] = bs
    misc[:, L.M_BI] = n2i_of[bidx, bi.long()] if nid else bi
    misc[:, L.M_BJ] = bj
    misc[:, L.M_CELLS] = cells
    misc[:, L.M_OVFL] = ovfl.to(I32)
    if nid:
        out = torch.zeros(B, LS, dtype=I32, device=dev)      # halves
    else:
        out = torch.zeros(B, max(LS, 8), dtype=torch.int64, device=dev)
    if LS == 0:
        return bsn[:, :R], mplr[:, :R], misc, out

    # ---- the walk: one BT read per step ----
    I_ = bi.clone()
    J = bj.clone()
    lane_w = J % WB
    cur = full(L.BT_ALL)
    if_ = torch.ones(B, dtype=torch.bool, device=dev)
    nst = full(0)
    fail = torch.zeros(B, dtype=torch.bool, device=dev)
    done = (bi <= 0) | (bj <= 0) | ovfl
    PI = n2i_of[bidx, bi.long()] if nid else None
    PJ = bj.clone()

    def pre_at(node, p):
        wv = pre[bidx, (node * P2 + (p >> 1)).long()]
        return ((wv >> (16 * (p & 1))) & 0xFFFF).clamp(max=R - 1)

    def bit(x, k):
        return ((x >> k) & 1) > 0

    NONE = full(99)
    no = torch.zeros(B, dtype=torch.bool, device=dev)
    kinds = ("m", "e1m") if gm == LINEAR_GAP else \
        ("m", "e1m", "e1x", "e2m", "e2x") if gm == CONVEX_GAP else \
        ("m", "e1m", "e1x")

    def late_picks(Il, J, lane_w, lo_i, inwin):
        """Topo mode, a pick field of 15 ("slot 15 or later, or none"):
        per condition, the first slot p in [15, npre) at which it holds at
        cell (I, J), as the sweep's bits test it, or 99, and that slot's
        open bit. The kernel searches only the conditions its walk takes;
        the others do not change a move."""
        out = {k: (NONE, no) for k in kinds}
        if nid or P <= 15:
            return out
        npre_i = ((ctrl[bidx, Il] >> 5) & 31).clamp(max=P)
        ok = inwin & (npre_i > 15)
        if not bool(ok.any()):
            return out
        ln = lane_w.long()
        hrow = H[bidx, Il, ln]
        e1row = E1[bidx, Il, ln] if gm != LINEAR_GAP else None
        e2row = E2[bidx, Il, ln] if gm == CONVEX_GAP else None
        # the row's query profile at column J, as the sweep loads it
        base = (ctrl[bidx, Il] & 31).long()
        k0 = lo_i // WB
        lomod = lo_i - k0 * WB
        fold = (base * KW1 + k0).clamp(0, m * KW1 - 2)
        qraw = qpf[bidx, torch.where(lane_w >= lomod, fold, fold + 1), ln]
        qraw = torch.where(base < m, qraw, zero)
        q = torch.where((J >= 1) & (J <= qlen), qraw, zero)
        lm = ((lane_w - 1) % WB).long()
        for p in range(15, P):
            pred = pre_at(Il, p).long()
            pv = ok & (p < npre_i)
            pw = bsn[bidx, pred]
            pbel = (pw & 0xFFFF) | ((pw >> 16) << 10) | (1 << 20)
            pvc = (pbel >> 20) > 0
            plo = (pbel & 1023) * pn
            phi = (((pbel >> 10) & 1023) + 1) * pn - 1
            okp = pvc & (J >= plo) & (J <= phi)
            m_in = pvc & (J - 1 >= plo) & (J - 1 <= phi)
            bh = torch.where(okp, H[bidx, pred, ln], NEGt)
            hits = {"m": ((torch.where(m_in, H[bidx, pred, lm], NEGt) + q)
                          == hrow, no)}
            if gm == LINEAR_GAP:
                hits["e1m"] = ((bh - e1) == hrow, no)
            else:
                be1 = torch.where(okp, E1[bidx, pred, ln], NEGt)
                o1 = (bh - oe1) == be1
                hits["e1m"] = (hrow == be1, o1)
                hits["e1x"] = (e1row == (be1 - e1), o1)
                if gm == CONVEX_GAP:
                    be2 = torch.where(okp, E2[bidx, pred, ln], NEGt)
                    o2 = (bh - oe2) == be2
                    hits["e2m"] = (hrow == be2, o2)
                    hits["e2x"] = (e2row == (be2 - e2), o2)
            for k, (hit, o) in hits.items():
                sl, op = out[k]
                take = pv & hit & (sl == 99)
                out[k] = (torch.where(take, p, sl), torch.where(take, o, op))
        return out

    CHECK = 32
    it = 0
    while True:
        if it % CHECK == 0 and bool(done.all()):
            break
        it += 1
        act = ~done
        Il = I_.long()
        wv = bsn[bidx, Il]
        lo_i = (wv & 0xFFFF) * pn
        braw = BT[bidx, Il, lane_w.long()]
        inwin = (J >= lo_i) & (J < lo_i + WB)
        b = torch.where(inwin, braw, L.INVALID_BITS)
        curM = (cur & L.BT_M) > 0
        # pick slots (99: none); a field of 15 takes the late search's
        lp = late_picks(Il, J, lane_w, lo_i, inwin)

        def slot(field, kind):
            return (torch.where(field < 15, field, lp[kind][0]),
                    lp[kind][1])
        mslot = slot(b & 15, "m")[0]
        m_possible = mslot < 99
        if gm == LINEAR_GAP:
            e_pick_p = slot((b >> 4) & 15, "e1m")[0]
            e_possible = e_pick_p < 99
            e_op_sel = full(L.BT_ALL)
            f_possible = bit(b, 24)
            f_op_sel = full(L.BT_ALL)
        else:
            def pick(fm, fx, om, ox, km, kx):
                """(slot, open bit) of an E condition: the M-state
                field under curM, else the X-state one."""
                f = torch.where(curM, (b >> fm) & 15, (b >> fx) & 15)
                sm, lom = slot(f, km)
                sx, lox = slot(f, kx)
                late_o = torch.where(curM, lom, lox)
                o = torch.where(f < 15, torch.where(curM, bit(b, om),
                                                    bit(b, ox)), late_o)
                return torch.where(curM, sm, sx), o
            pe1, e1open = pick(4, 8, 12, 13, "e1m", "e1x")
            e1hit = ((cur & L.BT_E1) > 0) & (pe1 < 99)
            if gm == CONVEX_GAP:
                pe2, e2open = pick(14, 18, 22, 23, "e2m", "e2x")
                e2hit = ((cur & L.BT_E2) > 0) & (pe2 < 99)
            else:
                pe2 = NONE
                e2open = torch.zeros_like(curM)
                e2hit = torch.zeros_like(curM)
            k1 = torch.where(e1hit, 2 * pe1, 99)
            k2 = torch.where(e2hit, 2 * pe2 + 1, 99)
            use_e1 = k1 <= k2
            e_possible = torch.minimum(k1, k2) < 99
            e_pick_p = torch.where(use_e1, pe1, pe2)
            mf = full(L.BT_M | L.BT_F)
            e_op_sel = torch.where(
                use_e1, torch.where(e1open, mf, full(L.BT_E1)),
                torch.where(e2open, mf, full(L.BT_E2)))
            me = full(L.BT_M | L.BT_E)
            f1o, f1x, f1g = bit(b, 24), bit(b, 25), bit(b, 26)
            hit_f1 = (((cur & L.BT_F1) > 0) & torch.where(curM, f1g, True)
                      & (f1o | f1x))
            op_f1 = torch.where(f1o, me, full(L.BT_F1))
            if gm == CONVEX_GAP:
                f2o, f2x, f2g = bit(b, 27), bit(b, 28), bit(b, 29)
                hit_f2 = (((cur & L.BT_F2) > 0)
                          & torch.where(curM, f2g, True) & (f2o | f2x))
                op_f2 = torch.where(f2o, me, full(L.BT_F2))
            else:
                hit_f2 = torch.zeros_like(curM)
                op_f2 = full(L.BT_ALL)
            f_possible = hit_f1 | hit_f2
            f_op_sel = torch.where(hit_f1, op_f1, op_f2)
        use_m1 = curM & ~if_ & m_possible
        use_e = ~use_m1 & e_possible
        if gm != LINEAR_GAP:
            use_e = use_e & ((cur & L.BT_E) > 0)
        use_f = ~use_m1 & ~use_e & f_possible
        if gm != LINEAR_GAP:
            use_f = use_f & ((cur & L.BT_F) > 0)
        use_m2 = ~use_m1 & ~use_e & ~use_f & if_ & m_possible
        if gm != LINEAR_GAP:
            use_m2 = use_m2 & curM
        any_hit = use_m1 | use_e | use_f | use_m2
        use_m = use_m1 | use_m2
        m_pred = pre_at(I_, mslot.clamp(max=P - 1))
        e_pred = pre_at(I_, e_pick_p.clamp(max=P - 1))
        op_code = torch.where(use_m, 0, torch.where(use_e, 2, 1)).to(I32)
        emit = act & any_hit
        sel = emit.nonzero()[:, 0]
        if nid:
            ti = n2i_of[bidx, Il]
            hw = (op_code | ((PJ - J) << 2) | ((PI - ti) << 3)) & 0xFFFF
            out[sel, nst[sel].long()] = hw[sel]
            PI = torch.where(emit, ti, PI)
            PJ = torch.where(emit, J, PJ)
        else:
            word = pack_steps(op_code, I_, J)
            out[sel, nst[sel].long()] = word[sel]
        nst = nst + emit.to(I32)
        new_i = torch.where(use_m, m_pred, torch.where(use_e, e_pred, I_))
        dj = use_m | use_f
        new_j = J - dj.to(I32)
        nl = lane_w - dj.to(I32)
        new_lane = torch.where(nl < 0, nl + WB, nl)
        new_cur = torch.where(use_m, full(L.BT_ALL),
                              torch.where(use_e, e_op_sel,
                                          torch.where(use_f, f_op_sel, cur)))
        step_fail = ~any_hit
        I_ = torch.where(act, new_i, I_)
        J = torch.where(act, new_j, J)
        lane_w = torch.where(act, new_lane, lane_w)
        cur = torch.where(act, new_cur, cur)
        if_ = torch.where(act & use_m, False, if_)
        fail = fail | (act & step_fail)
        done = done | (act & (step_fail | (new_i <= 0) | (new_j <= 0)
                              | (nst >= LS)))
    misc[:, L.M_NSTEPS] = nst
    misc[:, L.M_FAIL] = fail.to(I32)
    misc[:, L.M_ENDI] = n2i_of[bidx, I_.long()] if nid else I_
    misc[:, L.M_ENDJ] = J
    if nid:
        misc[:, L.M_LASTI] = PI
        out = (out[:, 0::2] | (out[:, 1::2] << 16)).contiguous()
    return bsn[:, :R], mplr[:, :R], misc, out
