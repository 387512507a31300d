"""FASTA/FASTQ(.gz) reading (kseq-equivalent).

reference: abPOA src/kseq.h (vendored klib) + abpoa_seq.c:160-180.
"""
from __future__ import annotations

import dataclasses
import gzip
import io


@dataclasses.dataclass
class SeqRecord:
    name: str = ""
    comment: str = ""
    seq: str = ""
    qual: str = ""


def _open_maybe_gz(fn: str):
    f = open(fn, "rb")
    head = f.read(2)
    f.seek(0)
    if head == b"\x1f\x8b":
        return io.TextIOWrapper(gzip.GzipFile(fileobj=f))
    return io.TextIOWrapper(f)


def read_seqs(fn: str) -> list[SeqRecord]:
    """Parse all records of a FASTA/FASTQ (optionally gzipped) file."""
    recs: list[SeqRecord] = []
    with _open_maybe_gz(fn) as fp:
        rec = None
        mode = None  # 'fa' | 'fq'
        qual_left = 0
        for line in fp:
            line = line.rstrip("\n").rstrip("\r")
            if qual_left > 0 and rec is not None:
                rec.qual += line
                qual_left -= len(line)
                continue
            if not line:
                continue
            c = line[0]
            if c == ">" or c == "@":
                if rec is not None:
                    recs.append(rec)
                toks = line[1:].split(None, 1)
                rec = SeqRecord(name=toks[0] if toks else "",
                                comment=toks[1] if len(toks) > 1 else "")
                mode = "fa" if c == ">" else "fq"
            elif c == "+" and mode == "fq":
                qual_left = len(rec.seq)
            else:
                if rec is not None:
                    rec.seq += line
        if rec is not None:
            recs.append(rec)
    return recs
