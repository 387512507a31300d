"""Entry kind ``cli``: one call is the port's command line in process,
``abpoa_tpu_torch.cli.main([<cluster.fa>, "-o", <out>, ...flags])``, on
one cluster file of the pool, as the upstream's ``abpoa seq.fa >
cons.fa`` is run once per file. The answer is the output file's text."""
from __future__ import annotations

import contextlib
import io
import os

from consbench import gen

SPAN = "cli.main"

# configuration field -> the abpoa flag that sets it
FLAGS = {"align_mode": "-m", "match": "-M", "mismatch": "-X",
         "wb": "-b", "wf": "-f", "k": "-k", "w": "-w", "min_w": "-n",
         "max_n_cons": "-d", "min_freq": "-q"}
PAIRS = {"gap_open1": ("-O", "gap_open2"), "gap_ext1": ("-E", "gap_ext2")}
SWITCHES = {"disable_seeding": ("-S", False), "progressive_poa": ("-p", True),
            "amb_strand": ("-s", True)}


def flags(fields: dict) -> list[str]:
    """abpoa command-line flags that set a configuration's fields."""
    out = []
    seconds = {v[1] for v in PAIRS.values()}
    for k, v in fields.items():
        if k in FLAGS:
            out += [FLAGS[k], str(v)]
        elif k in PAIRS:
            flag, second = PAIRS[k]
            out += [flag, f"{v},{fields[second]}"]
        elif k in SWITCHES:
            flag, on = SWITCHES[k]
            if bool(v) == on:
                out.append(flag)
        elif k not in seconds:
            raise KeyError(f"no abpoa flag sets {k!r}")
    return out


class Driver:
    span = SPAN

    def __init__(self, fields: dict, device: str, workdir):
        from abpoa_tpu_torch import cli
        self._main = cli.main
        self.args = flags(fields) + ["--device", device.split(":")[0]]
        self.workdir = workdir
        self.out = os.path.join(workdir, "cons.fa")

    def units(self, pool):
        """[(cluster ids, file)]: one FASTA file per cluster of the pool,
        written under the run's work directory."""
        out = []
        for b, batch in enumerate(pool):
            for k, reads in enumerate(batch):
                path = os.path.join(self.workdir, f"c{b}_{k}.fa")
                with open(path, "w") as fh:
                    fh.write(gen.to_fasta(reads))
                out.append(([(b, k)], path))
        return out

    def call(self, path):
        """(answers, counters): the output file's text, one answer; none
        where the command failed."""
        with contextlib.redirect_stderr(io.StringIO()):
            rc = self._main([path, "-o", self.out] + self.args)
        if rc != 0:
            return [], {"failed_calls": 1}
        with open(self.out) as fh:
            return [fh.read()], {}

    @staticmethod
    def render(cons):
        """The output file of a correct call (abpoa_output_fx_consensus;
        the configurations ask for one consensus, -d 1)."""
        return "".join(f">Consensus_sequence\n{c}\n" for c in cons)
