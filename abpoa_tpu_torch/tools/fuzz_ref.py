"""Differential fuzzer of the port's CLI over its whole flag surface.

    python -m abpoa_tpu_torch.tools.fuzz_ref --n N --start S \\
        --device cuda|cpu [--list-mode] [--shapes CLASS] [--keep-going] \\
        [--ref oracle|binary]

The counterpart of ``tools/fuzz_ref.py``. Each seed makes one case with
the same draws in the same order as that tool (``gen_case``,
``gen_list_case``): a read set (mutated copies of a random ancestor, or
of two haplotypes under multi-consensus) crossed with a flag vector
over global/local/extend modes, linear/affine/convex gaps and matrix
files, banding (-b -1/0/1/5, -f), -d 2/3, -r 0-5, -s, -S/-p, FASTQ with
-Q, protein -c, -i restores and gz input; ``--list-mode`` makes -l
cases of 4-7 files.

Reference side (``--ref oracle``, the default): the port's CLI with
``--engine numpy``, the bit-exact host oracle, in this process. The -i
restore file is made by the reference side from the first read set. A
list case runs the reference once per file and concatenates the
outputs (the reference's own -l loop leaks FASTQ qualities from one
file into the next under -Q; per-file runs are its defined semantics).
``--ref binary`` runs ``.refbuild/bin/abpoa`` instead (the sanitized
build, CANARY_BYTE=0x00), where it exists.

Our side: the port's CLI with ``--engine torch --device DEV``: the serial
device engine, or with -l and 4 or more files ``batch_msa_from_files``
(the device loop, the round path or the seeded batch path, as the flags
decide).

Contract: when both sides succeed, equal output bytes; where the
reference exits non-zero, ours does too. An exception out of the CLI
counts as a non-zero exit and is recorded. Each seed's line names the
kernels our side launched (the wrappers' launch counts; none on the
CPU, where the wrappers run their plain versions).

``--shapes CLASS`` draws from ``gen_shape_case`` instead: inputs sized to
reach shapes that the cases above do not (bands over 1024 lanes, graphs
near and past 4096 rows, nodes past 253 predecessors, partial row masks
on seeded windows, nodes of 17-30 predecessors under -m 2), serially or
with ``--list-mode`` as -l over 4 files.
Such a case also fails when the reference's alignments never reached
its shape or, on the card, when the kernel that the shape should reach
was not launched.

A failing seed prints its description and flags and saves a repro
(input, args, both outputs) under ``--repro-dir``/SEED; the run exits 1.
``--device cuda`` with no usable GPU exits 1 with the CLI's error: the
oracle never runs on both sides.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gzip
import io
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parents[2]
REF_BIN = REPO / ".refbuild" / "bin" / "abpoa"

NT = "ACGT"
AA = "ARNDCQEGHILKMFPSTWYVBZX"  # 23 of the 26-letter aa alphabet
RC = str.maketrans("ACGTacgt", "TGCAtgca")

# the kernel wrappers whose launch counts a case reports, then the
# instances counted apart: B1 at four positions a thread, B2 with its
# state in global memory (unit and qv weights), B3 at four positions a
# thread and past 16 predecessor slots
KERNELS = ("band_dp", "graph_update", "band_dp_topo", "fw_dp", "tile_dp",
           "topo", "band_dp_wide", "graph_update_global",
           "graph_update_qv_global", "band_dp_topo_wide", "band_dp_topo_fan")
SHAPES = ("wide", "long", "hub", "svmask", "fan")


# ------------------------------------------------------------------ #
# generator: the draws of tools/fuzz_ref.py, in its order
def _mutate(rng, seq: str, alpha: str, sub_p: float, ind_p: float) -> str:
    out = []
    i = 0
    n = len(seq)
    while i < n:
        r = rng.random()
        if r < ind_p / 2:                      # deletion
            i += 1
            continue
        if r < ind_p:                          # insertion
            out.append(alpha[rng.integers(len(alpha))])
            continue                           # retry same position
        c = seq[i]
        if rng.random() < sub_p:
            c = alpha[rng.integers(len(alpha))]
        out.append(c)
        i += 1
    return "".join(out) or alpha[0]


def gen_case(seed: int):
    """-> (fasta_text, is_fastq, args:list[str], descr:str, incr), incr
    being (first read set's text, the flags that make the -i file) or
    None."""
    rng = np.random.default_rng(seed)
    is_aa = rng.random() < 0.15
    alpha = AA if is_aa else NT
    if (not is_aa) and rng.random() < 0.12:
        L = int(rng.integers(600, 3000))
        n_reads = int(rng.integers(2, 7))
    else:
        L = int(rng.integers(15, 401))
        n_reads = int(rng.integers(1, 13))
    sub_p = float(rng.choice([0.0, 0.02, 0.05, 0.1, 0.2]))
    ind_p = float(rng.choice([0.0, 0.01, 0.03, 0.08]))
    anc = "".join(alpha[k] for k in rng.integers(0, len(alpha), L))

    args: list[str] = []
    descr = ["aa" if is_aa else "nt", f"L={L}", f"n={n_reads}"]
    if is_aa:
        args += ["-c"]

    m = int(rng.choice([0, 0, 0, 1, 2]))
    if m:
        args += ["-m", str(m)]
        descr.append(f"m={m}")
    if m == 2 and rng.random() < 0.5:
        args += ["-z", str(int(rng.integers(20, 200)))]
    if m == 2 and rng.random() < 0.5:
        args += ["-e", str(int(rng.integers(0, 20)))]

    if rng.random() < 0.2:
        args += ["-t", str(REPO / ("BLOSUM62.mtx" if is_aa
                                   else "HOXD70.mtx"))]
    elif rng.random() < 0.3:
        args += ["-M", str(int(rng.integers(1, 6))),
                 "-X", str(int(rng.integers(1, 9)))]

    gm = rng.choice(["convex", "affine", "linear", "default"])
    if gm == "affine":
        args += ["-O", f"{int(rng.integers(1, 9))},0",
                 "-E", str(int(rng.integers(1, 5)))]
    elif gm == "linear":
        args += ["-O", "0", "-E", str(int(rng.integers(1, 5)))]
    elif gm == "convex":
        o1 = int(rng.integers(1, 9))
        args += ["-O", f"{o1},{o1 + int(rng.integers(1, 30))}",
                 "-E", f"{int(rng.integers(2, 5))},1"]
    descr.append(gm)

    b = int(rng.choice([-1, 0, 1, 5, 10]))
    if b != 10:
        args += ["-b", str(b)]
    if rng.random() < 0.4:
        args += ["-f", str(rng.choice([0.0, 0.05, 0.2]))]

    d = int(rng.choice([1, 1, 1, 2, 2, 3]))
    if d > 1:
        args += ["-d", str(d)]
        if rng.random() < 0.5:
            args += ["-q", str(rng.choice([0.1, 0.25, 0.3]))]

    r = int(rng.integers(0, 6))
    if r:
        args += ["-r", str(r)]
    descr.append(f"r={r}")

    amb = (not is_aa) and rng.random() < 0.25
    if amb:
        args += ["-s"]

    if m == 0 and rng.random() < 0.3:
        args += ["-S"]
        if rng.random() < 0.6:
            args += ["-k", str(int(rng.choice([3, 5, 7] if is_aa
                                              else [5, 9, 13, 19])))]
            args += ["-w", str(int(rng.choice([3, 5, 10])))]
            args += ["-n", str(int(rng.choice([10, 30, 100, 500])))]
        if rng.random() < 0.5:
            args += ["-p"]
        descr.append("S")

    is_fastq = (not is_aa) and rng.random() < 0.3
    if is_fastq and rng.random() < 0.7:
        args += ["-Q"]
        descr.append("Q")

    # incremental restore (-i): the reference's output on a first read
    # set becomes the starting graph of both sides
    incr = None
    if (not is_aa) and m == 0 and "-S" not in args \
            and rng.random() < 0.15:
        n0 = int(rng.integers(2, 7))
        lines0 = []
        for i in range(n0):
            seq = _mutate(rng, anc, alpha, sub_p, ind_p)
            lines0.append(f">base{i}\n{seq}")
        fmt = "-r3" if rng.random() < 0.6 else "-r1"
        incr = ("\n".join(lines0) + "\n", [fmt])
        descr.append(f"i({fmt})")

    haps = [anc]
    if d > 1 and n_reads >= 4:
        haps.append(_mutate(rng, anc, alpha, 0.08, 0.02))

    lines = []
    for i in range(n_reads):
        hap = haps[int(rng.integers(len(haps)))]
        seq = _mutate(rng, hap, alpha, sub_p, ind_p)
        if amb and rng.random() < 0.4:
            seq = seq.translate(RC)[::-1]
        if (not is_aa) and rng.random() < 0.05:
            pos = rng.integers(0, len(seq), max(1, len(seq) // 50))
            sl = list(seq)
            for p in pos:
                sl[p] = "N"
            seq = "".join(sl)
        if is_fastq:
            qual = "".join(chr(33 + int(q))
                           for q in rng.integers(0, 41, len(seq)))
            lines.append(f"@read{i}\n{seq}\n+\n{qual}")
        else:
            lines.append(f">read{i}\n{seq}")
    return ("\n".join(lines) + "\n", is_fastq, args, " ".join(descr),
            incr)


def gen_list_case(seed: int, workdir: pathlib.Path):
    """List-mode (-l) case: 4-7 single-instance files from gen_case's
    inputs under derived seeds; the flags come from the base seed.
    -> (list file, args, descr)"""
    rng = np.random.default_rng(10_000_019 + seed)
    k = int(rng.integers(4, 8))
    fns = []
    for i in range(k):
        text, is_fq, _, _, _ = gen_case(200_000 + seed * 8 + i)
        p = workdir / (f"li{i}.fq" if is_fq else f"li{i}.fa")
        p.write_text(text)
        fns.append(str(p))
    lst = workdir / "in.list"
    lst.write_text("\n".join(fns) + "\n")
    args = ["-l"]
    r = int(rng.integers(0, 6))
    if r:
        args += ["-r", str(r)]
    if rng.random() < 0.3:
        args += ["-d", "2"]
    if rng.random() < 0.3:
        args += ["-Q"]
    return lst, args, f"list k={k} r={r}"


# ------------------------------------------------------------------ #
# shape classes
@dataclasses.dataclass
class ShapeCase:
    """One shape-class case: one FASTA text per input file (one file
    serially, four under -l), the flags, and the kernels of which at
    least one must launch on the card."""
    texts: list
    args: list
    descr: str
    want: tuple


def _fasta(seqs):
    return "".join(f">read{i}\n{s}\n" for i, s in enumerate(seqs))


def _rand(rng, alpha, n):
    return "".join(alpha[k] for k in rng.integers(0, len(alpha), n))


def _wide(rng, n_files, list_mode):
    # -b 520-800 (or -f 0.35-0.6): w >= 520, so pick_WB = qlen + 1 +
    # 2 pn rounded to 128 lanes: over 1024 for every read past ~960 bp
    args = ["-b", str(int(rng.integers(520, 801)))]
    if rng.random() < 0.3:
        args = ["-b", "10", "-f", str(round(float(rng.uniform(0.35, 0.6)),
                                            2))]
    if rng.random() < 1 / 3:
        args += ["-m", "2"]
    texts = []
    for _ in range(n_files):
        anc = _rand(rng, NT, int(rng.integers(1000, 1601)))
        n = int(rng.integers(3, 6))
        texts.append(_fasta(_mutate(rng, anc, NT, 0.03, 0.02)
                            for _ in range(n)))
    # serially B5 sweeps several tiles a row; under -l the device loop's
    # B1 at four positions a thread (its B2 state, R <= 2,112, stays in
    # shared memory), with -m 2 the round path's B3 at four positions a
    # thread (reads of at most ~1,650 bp keep pick_WB at 1,792 lanes or
    # fewer, within its 2048)
    if not list_mode:
        want = ("tile_dp",)
    else:
        want = ("band_dp_topo_wide",) if "-m" in args else ("band_dp_wide",)
    return texts, args, "wide " + " ".join(args), want


def _long(rng, n_files, list_mode):
    mode = str(rng.choice(["default", "m1", "S"]))
    args = {"default": [], "m1": ["-m", "1"], "S": ["-S"]}[mode]
    texts = []
    for _ in range(n_files):
        # 3650 bp at least: the first read's graph keeps 3600 nodes
        anc = _rand(rng, NT, int(rng.integers(3650, 5501)))
        n = int(rng.integers(2, 4))
        texts.append(_fasta(_mutate(rng, anc, NT, 0.02, 0.01)
                            for _ in range(n)))
    # -l by default: the round path's B3 past 4096 rows (the loop sizes
    # R = 4096 for these reads, past its graph kernel's shared memory)
    if not list_mode:
        want = ("tile_dp",) if mode == "default" else ("fw_dp",)
    else:
        want = {"default": ("band_dp_topo",), "m1": ("fw_dp",),
                "S": ("band_dp_topo", "fw_dp")}[mode]
    return texts, args, f"long {mode}", want


def hub_reads(rng, alpha, n):
    """n reads of a hub: read 0 is a backbone pre + post; read k is
    pre[:-k] + post: a deletion of pre's last k residues, so the first
    residue of post gains a predecessor a read (read k's cheapest
    deletion runs through read k-1's new edge). pre has no two equal
    neighbours and lacks post's first residue, so no deletion can slide
    off that node."""
    h = alpha[-1]
    pre = [alpha[0]]
    for _ in range(n + int(rng.integers(20, 61))):
        pre.append(rng.choice([c for c in alpha[:-1] if c != pre[-1]]))
    pre = "".join(pre)
    post = h + _rand(rng, alpha, int(rng.integers(15, 31)))
    return [pre[:len(pre) - k] + post for k in range(n)]


def _hub(rng, n_files, list_mode):
    aa = bool(rng.random() < 0.5)
    alpha = AA if aa else NT
    local = bool(rng.random() < 0.5)
    args = (["-c"] if aa else []) + (["-m", "1"] if local else [])
    texts = [_fasta(hub_reads(rng, alpha, int(rng.integers(260, 301))))
             for _ in range(n_files)]
    # -l: the loop's 8 predecessor slots and the band kernel's 16 are
    # out: the round path's full-width kernel
    want = ("fw_dp",) if local or list_mode else ("tile_dp",)
    return texts, args, f"hub {'aa' if aa else 'nt'}" + \
        (" m=1" if local else ""), want


def _svmask(rng, n_files, list_mode):
    # a share of the reads carry, at two sites, a 150-400 bp segment of
    # their own in place of the others' (an insertion against them, and
    # a deletion): two long branches, so a window that starts inside one
    # spans rows of the other that its start does not reach
    args = ["-S", "-k", str(int(rng.integers(9, 16))),
            "-w", str(int(rng.integers(5, 11))),
            "-n", str(int(rng.integers(10, 31)))]
    if rng.random() < 0.3:
        args += ["-p"]
    texts = []
    for _ in range(n_files):
        anc = _rand(rng, NT, int(rng.integers(1000, 1601)))
        alt = anc
        for site in range(2):      # one near each end
            pos = int(rng.integers(150, 400)) if site == 0 else \
                len(alt) - int(rng.integers(450, 600))
            sv = int(rng.integers(150, 401))
            alt = alt[:pos] + _rand(rng, NT, sv) + alt[pos + sv:]
        n = int(rng.integers(6, 11))
        k_sv = max(1, int(round(n * float(rng.uniform(0.25, 0.5)))))
        texts.append(_fasta(_mutate(rng, alt if i < k_sv else anc, NT,
                                    0.02, 0.01) for i in range(n)))
    return texts, args, "svmask " + " ".join(args), \
        ("band_dp_topo", "fw_dp") if list_mode else ("fw_dp",)


def _fan(rng, n_files, list_mode):
    # hub_reads at 18-30 reads: the last read aligns to a node of 17-29
    # predecessors, -m 2. Serially B5 (B4 for a re-run); under -l the
    # round path's B3 past 16 predecessor slots (the device loop is
    # global only)
    aa = bool(rng.random() < 0.5)
    args = (["-c"] if aa else []) + ["-m", "2"]
    texts = [_fasta(hub_reads(rng, AA if aa else NT,
                              int(rng.integers(18, 31))))
             for _ in range(n_files)]
    want = ("band_dp_topo_fan",) if list_mode else ("tile_dp", "fw_dp")
    return texts, args, f"fan {'aa' if aa else 'nt'}", want


_SHAPE_GEN = {"wide": _wide, "long": _long, "hub": _hub,
              "svmask": _svmask, "fan": _fan}


def gen_shape_case(cls: str, seed: int, list_mode=False) -> ShapeCase:
    """A case of shape class `cls` (one of SHAPES): one input file, or
    four under -l. See the module docstring and ``shape_reached``."""
    rng = np.random.default_rng(30_000_000 + SHAPES.index(cls) * 1_000_003
                                + seed)
    texts, args, descr, want = _SHAPE_GEN[cls](rng, 4 if list_mode else 1,
                                               list_mode)
    if list_mode:
        args, descr = ["-l"] + args, f"list {descr}"
    return ShapeCase(texts, args, descr, want)


@dataclasses.dataclass
class Facts:
    """What the reference side's alignments reached: the widest band
    tile (``pick_WB`` of each alignment's query and lane count), the
    largest graph and the largest in-degree of a graph aligned to, and
    the count of seeded windows whose reachability mask leaves rows of
    the window out."""
    wb: int = 0
    nodes: int = 0
    indeg: int = 0
    partial: int = 0

    def summary(self):
        return (f"WB {self.wb}, nodes {self.nodes}, in-degree {self.indeg}, "
                f"partial masks {self.partial}")


def shape_reached(cls: str, f: Facts) -> bool:
    return {"wide": f.wb > 1024, "long": f.nodes >= 3600,
            "hub": f.indeg > 253, "svmask": f.partial > 0,
            "fan": 16 < f.indeg <= 30}[cls]


@contextlib.contextmanager
def _recording(facts: Facts):
    """Record the oracle's alignments (every alignment of the host
    oracle goes through one engine_np._Ctx) into `facts`."""
    from ..align import engine_np
    from ..align.export import pick_WB
    base = engine_np._Ctx

    class Recording(base):
        def __init__(self, g, p, beg_id, end_id, beg, end, imap, *a):
            super().__init__(g, p, beg_id, end_id, beg, end, imap, *a)
            facts.wb = max(facts.wb, pick_WB(p, self.qlen, self.pn))
            facts.nodes = max(facts.nodes, g.node_n)
            facts.indeg = max(facts.indeg,
                              int(g.build_csr()["in_cnt"].max(initial=0)))
            facts.partial += not imap[beg:end + 1].all()
    engine_np._Ctx = Recording
    try:
        yield facts
    finally:
        engine_np._Ctx = base


# ------------------------------------------------------------------ #
# the two sides
def _launches():
    from ..ops.band_dp import band_poa_dp_packed, band_poa_dp_batch
    from ..ops.fw_dp import fw_poa_dp_batch
    from ..ops.graph_update import graph_update_packed
    from ..ops.tile_dp import tile_poa_dp_batch
    from ..ops.topo import topo_batch
    ws = (band_poa_dp_packed, graph_update_packed, band_poa_dp_batch,
          fw_poa_dp_batch, tile_poa_dp_batch, topo_batch)
    return dict(zip(KERNELS, [w.launches for w in ws] + [
        band_poa_dp_packed.wide_launches,
        graph_update_packed.global_launches,
        graph_update_packed.qv_global_launches,
        band_poa_dp_batch.wide_launches, band_poa_dp_batch.fan_launches]))


def _cli(argv, out: pathlib.Path):
    """The port's CLI in this process -> (rc, output bytes, stderr
    tail). An exception out of cli.main is a non-zero exit (the
    reference's analogs are err_fatal exits and aborts)."""
    from .. import cli
    if out.exists():
        out.unlink()
    err = io.StringIO()
    try:
        with contextlib.redirect_stdout(io.StringIO()), \
                contextlib.redirect_stderr(err):
            rc = cli.main([*argv, "-o", str(out)])
    except Exception as e:  # noqa: BLE001 -- recorded, not swallowed
        rc = 2
        err.write(f" EXC {e!r}")
    body = out.read_bytes() if out.exists() else b""
    return rc, body, err.getvalue()[-300:]


class Sides:
    """The reference side (`ref`: "oracle", the port's CLI with
    --engine numpy, or "binary") and our side (the port's CLI on
    `device`) of a campaign, in `workdir`."""

    def __init__(self, device="cuda", ref="oracle", workdir=None):
        self.device, self.ref, self.work = device, ref, workdir

    def reference(self, inp: pathlib.Path, args):
        if self.ref == "binary":
            env = dict(os.environ, CANARY_BYTE="0x00")
            r = subprocess.run([str(REF_BIN), *args, str(inp)],
                               capture_output=True, env=env, timeout=600)
            return r.returncode, r.stdout, r.stderr[-300:].decode(
                errors="replace")
        return _cli([*args, "--engine", "numpy", str(inp)],
                    self.work / "ref.out")

    def reference_per_file(self, lst: pathlib.Path, args):
        """A list's reference: each file on its own, outputs joined."""
        sargs = [x for x in args if x != "-l"]
        rc, body, err = 0, b"", ""
        for fn in lst.read_text().splitlines():
            rc1, out1, err1 = self.reference(pathlib.Path(fn), sargs)
            body += out1
            if rc1 != 0:
                rc, err = rc1, err1
        return rc, body, err

    def ours(self, inp: pathlib.Path, args):
        """-> (rc, bytes, stderr tail, kernel launches by name)"""
        before = _launches()
        rc, body, err = _cli([*args, "--engine", "torch", "--device",
                              self.device, str(inp)], self.work / "ours.out")
        after = _launches()
        return rc, body, err, {k: after[k] - before[k] for k in KERNELS
                               if after[k] != before[k]}


@dataclasses.dataclass
class Result:
    """One seed's outcome: ok, its description, both outputs, the flags,
    the input text (for the repro), our side's kernel launches, the
    reference's facts (shape cases) and the seconds of both sides."""
    ok: bool
    descr: str
    ref: bytes
    got: bytes
    args: list
    text: str
    launches: dict
    facts: Facts | None = None
    reached: bool | None = None
    seconds: float = 0.0


def _verdict(ref_rc, ref, ref_err, got_rc, got):
    """(ok, note): the parity contract."""
    if ref_rc != 0:
        return got_rc != 0, f" [ref-fatal: {ref_err.strip()!r:.120}]"
    return got_rc == 0 and ref == got, ""


def run_case(seed: int, sides: Sides, list_mode=False) -> Result:
    """One gen_case (or gen_list_case) seed through both sides."""
    t0 = time.perf_counter()
    work = sides.work
    if list_mode:
        inp, args, descr = gen_list_case(seed, work)
        text = inp.read_text()
        ref_rc, ref, ref_err = sides.reference_per_file(inp, args)
    else:
        text, is_fastq, args, descr, incr = gen_case(seed)
        inp = work / ("in.fq" if is_fastq else "in.fa")
        if seed % 17 == 3:
            # gzipped input (the reference's reader opens .gz itself)
            inp = inp.with_suffix(inp.suffix + ".gz")
            with gzip.open(inp, "wt") as fp:
                fp.write(text)
            descr += " gz"
        else:
            inp.write_text(text)
        if incr is not None:
            base_text, gen_args = incr
            base_inp = work / "base.fa"
            base_inp.write_text(base_text)
            rc0, incr_bytes, _err0 = sides.reference(base_inp, gen_args)
            if rc0 != 0 or not incr_bytes.strip():
                return Result(True, descr + " [incr-gen-skip]", b"", b"",
                              args, text, {},
                              seconds=time.perf_counter() - t0)
            incr_fn = work / "incr.in"
            incr_fn.write_bytes(incr_bytes)
            args = args + ["-i", str(incr_fn)]
        ref_rc, ref, ref_err = sides.reference(inp, args)
    got_rc, got, got_err, launches = sides.ours(inp, args)
    ok, note = _verdict(ref_rc, ref, ref_err, got_rc, got)
    if not ok and got_rc != 0:
        note += f" [ours rc {got_rc}: {got_err.strip()!r:.160}]"
    return Result(ok, descr + note, ref, got, args, text, launches,
                  seconds=time.perf_counter() - t0)


def run_shape_case(cls: str, seed: int, sides: Sides,
                   list_mode=False) -> Result:
    """One shape-class seed: the parity contract, the shape reached by
    the reference's alignments, and on the card a launch of a kernel of
    the case's `want`."""
    t0 = time.perf_counter()
    case = gen_shape_case(cls, seed, list_mode)
    work = sides.work
    fns = []
    for i, text in enumerate(case.texts):
        p = work / f"sh{i}.fa"
        p.write_text(text)
        fns.append(p)
    if list_mode:
        inp = work / "in.list"
        inp.write_text("\n".join(map(str, fns)) + "\n")
    else:
        inp = fns[0]
    facts = Facts()
    with _recording(facts):
        if list_mode:
            ref_rc, ref, ref_err = sides.reference_per_file(inp, case.args)
        else:
            ref_rc, ref, ref_err = sides.reference(inp, case.args)
    got_rc, got, got_err, launches = sides.ours(inp, case.args)
    ok, note = _verdict(ref_rc, ref, ref_err, got_rc, got)
    if not ok and got_rc != 0:
        note += f" [ours rc {got_rc}: {got_err.strip()!r:.160}]"
    reached = shape_reached(cls, facts)
    if not reached:
        ok, note = False, note + " [shape not reached]"
    if sides.device != "cpu" and not any(launches.get(k) for k in case.want):
        ok, note = False, note + f" [no launch of {'/'.join(case.want)}]"
    return Result(ok, case.descr + note, ref, got, case.args,
                  "".join(case.texts), launches, facts, reached,
                  time.perf_counter() - t0)


def _save_repro(rd: pathlib.Path, res: Result):
    rd.mkdir(parents=True, exist_ok=True)
    (rd / "input").write_text(res.text)
    (rd / "args").write_text(" ".join(res.args) + "\n")
    (rd / "ref.out").write_bytes(res.ref)
    (rd / "got.out").write_bytes(res.got)


def _line(seed, res: Result):
    kern = " ".join(f"{k}={n}" for k, n in res.launches.items()) or "none"
    shape = f" | {res.facts.summary()}" if res.facts is not None else ""
    return (f"seed {seed:5d} {'OK  ' if res.ok else 'FAIL'} {res.descr}"
            f" | launches {kern}{shape} | {res.seconds:.1f} s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m abpoa_tpu_torch.tools.fuzz_ref")
    ap.add_argument("--n", type=int, default=100)
    ap.add_argument("--start", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--list-mode", action="store_true",
                    help="-l cases (4 or more files batch through "
                         "batch_msa_from_files on our side)")
    ap.add_argument("--shapes", choices=SHAPES, default=None,
                    help="draw the cases of this shape class")
    ap.add_argument("--ref", choices=("oracle", "binary"), default="oracle")
    ap.add_argument("--keep-going", action="store_true")
    ap.add_argument("--repro-dir", default=os.path.join(
        tempfile.gettempdir(), "abpoa_torch_fuzz"))
    a = ap.parse_args(argv)
    if a.ref == "binary" and not REF_BIN.exists():
        print(f"error: {REF_BIN} not found (tests/golden/"
              "make_sanitized_ref.sh builds it)", file=sys.stderr)
        return 2
    if a.shapes and a.ref != "oracle":
        print("error: --shapes reads the oracle's alignments: --ref oracle",
              file=sys.stderr)
        return 2
    from ..device import resolve_device
    try:
        resolve_device(a.device)
    except RuntimeError as e:
        print(f"[abpoa_tpu_torch] RuntimeError: {e}", file=sys.stderr)
        return 1
    work = pathlib.Path(tempfile.mkdtemp(prefix="abpoa_torch_fuzz."))
    sides = Sides(a.device, a.ref, work)
    fails = []
    ran = reached = 0
    t0 = time.perf_counter()
    try:
        for seed in range(a.start, a.start + a.n):
            if a.shapes:
                res = run_shape_case(a.shapes, seed, sides, a.list_mode)
                reached += bool(res.reached)
            else:
                res = run_case(seed, sides, a.list_mode)
            ran += 1
            print(_line(seed, res), flush=True)
            if res.ok:
                continue
            fails.append(seed)
            rd = pathlib.Path(a.repro_dir) / str(seed)
            _save_repro(rd, res)
            print(f"  args: {' '.join(res.args)} -> {rd}", flush=True)
            if not a.keep_going:
                break
    finally:
        shutil.rmtree(work, ignore_errors=True)
    kind = (f"{a.shapes} " if a.shapes else "") + \
        ("list " if a.list_mode else "")
    print(f"\n{ran} {kind}cases from seed {a.start}: {ran - len(fails)} ok, "
          f"{len(fails)} failed" + (f" {fails}" if fails else "")
          + (f"; shape reached {reached}" if a.shapes else "")
          + f"; {time.perf_counter() - t0:.1f} s on {a.device}")
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
