"""abpoa_tpu_torch: the serial device engine (align/engine_torch.py) on
the CPU (the kernels' plain versions) against the port's bit-exact
oracle and the JAX engine (align_sequence_to_graph_jax), per align call,
as tests/test_engine_jax.py holds the JAX engine: score and cigar of
every call, and the band state written back into the graph (mpl/mpr by
node id) equal to the JAX engine's. Over the seven mode x gap cases of
that test, unbanded (-b -1), and a band tile forced too narrow, whose
M_OVFL routes every call to the full-width kernel. A B5 walk dead end
(M_FAIL, forced) re-runs on the full-width kernel too; a dead end there
raises. On a GPU, the engine on the card against the oracle and against
itself on the CPU. Exact equality.
"""
import pathlib

import numpy as np
import pytest
import torch

DATA = pathlib.Path(__file__).resolve().parent / "data"

torch.set_num_threads(1)

MODES = [
    ("global-convex", 0, 4, 24),
    ("global-affine", 0, 4, 0),
    ("global-linear", 0, 0, 0),
    ("local-convex", 1, 4, 24),
    ("local-affine", 1, 4, 0),
    ("local-linear", 1, 0, 0),
    ("extend-convex", 2, 4, 24),
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    return torch.device("cuda")


def _encoded(fn):
    from abpoa_tpu_torch.seqio import read_seqs
    from abpoa_tpu_torch.alphabet import encode_table
    tab = encode_table(5)
    return [tab[np.frombuffer(r.seq.encode(), dtype=np.uint8)]
            for r in read_seqs(str(DATA / fn))]


def _spy(monkeypatch, flag_b5=None, flag_fw=None):
    """Calls of the two DP wrappers the engine reaches, by kernel name;
    `flag_b5` / `flag_fw` name a misc flag to set in that wrapper's
    result."""
    from abpoa_tpu_torch.ops import fw_dp, tile_dp
    calls = {"tile_dp": 0, "fw_dp": 0}
    for mod, name, attr, flag in ((tile_dp, "tile_dp", "tile_poa_dp_batch",
                                   flag_b5),
                                  (fw_dp, "fw_dp", "fw_poa_dp_batch",
                                   flag_fw)):
        def wrapped(*a, _f=getattr(mod, attr), _name=name, _flag=flag):
            from abpoa_tpu_torch.ops import layout as L
            calls[_name] += 1
            out = _f(*a)
            if _flag:
                out.misc[:, getattr(L, _flag)] = 1
            return out
        monkeypatch.setattr(mod, attr, wrapped)
    return calls


def _band_state(g):
    """(mpl, mpr) by node id; None on an unbanded graph."""
    if g.node_id_to_max_pos_left is None:
        return None
    n = g.node_n
    return (np.array(g.node_id_to_max_pos_left[:n]),
            np.array(g.node_id_to_max_pos_right[:n]))


def _run_all(seqs, params, device, against="jax"):
    """Plain POA on two graphs in lockstep, fused with the port oracle's
    cigar; at every align call the port engine on `device`, the oracle,
    and the second engine on the second graph: the JAX package's
    (``against="jax"``) or the port's on the CPU (``"cpu"``, where JAX is
    not installed)."""
    from abpoa_tpu_torch import convert
    from abpoa_tpu_torch.align import engine_np, engine_torch
    from abpoa_tpu_torch.graph import POAGraph
    from abpoa_tpu_torch.params import SRC_NODE_ID, SINK_NODE_ID
    if against == "jax":
        from abpoa_tpu.align.engine_jax import align_sequence_to_graph_jax
        from abpoa_tpu.graph import POAGraph as OtherGraph
        p2 = params
    else:
        OtherGraph = POAGraph
        p2 = params = convert.params(params)

        def align_sequence_to_graph_jax(g, p, q):
            return engine_torch.align_sequence_to_graph_device(g, p, q,
                                                               "cpu")
    tparams = convert.params(params)
    gt, g2 = POAGraph(), OtherGraph()
    n_checked = 0
    for i, q in enumerate(seqs):
        if gt.node_n > 2:
            for g, p in ((gt, tparams), (g2, p2)):
                if not g.is_topological_sorted:
                    g.topological_sort(p)
            r_t = engine_torch.align_sequence_to_graph_device(
                gt, tparams, q, device)
            band_t = _band_state(gt)
            r_2 = align_sequence_to_graph_jax(g2, p2, q)
            band_2 = _band_state(g2)
            r_np = engine_np.align_sequence_to_subgraph(
                gt, tparams, SRC_NODE_ID, SINK_NODE_ID, q)
            for what, r in ((against, r_2), ("oracle", r_np)):
                assert r_t.best_score == r.best_score, (i, what)
                assert r_t.cigar == r.cigar, (i, what)
            assert (band_t is None) == (band_2 is None) == (params.wb < 0)
            if band_t is not None:
                for a, b in zip(band_t, band_2):
                    assert (a == b).all(), i
            cigar = r_np.cigar
            n_checked += 1
        else:
            cigar = []
        for g, p in ((gt, tparams), (g2, p2)):
            g.add_graph_alignment(p, q, [1] * len(q), cigar, None, i, True)
    assert n_checked > 0


def _case(name):
    """The JAX package's Params of a case (a dataclass module that needs
    no JAX)."""
    from abpoa_tpu.params import Params
    if name == "unbanded":
        return Params(wb=-1).post_set()
    if name == "overflow":
        return Params().post_set()
    _, amode, o1, o2 = next(m for m in MODES if m[0] == name)
    return Params(align_mode=amode, gap_open1=o1, gap_open2=o2).post_set()


CASES = [m[0] for m in MODES] + ["unbanded", "overflow"]


@pytest.mark.parametrize("case", CASES)
def test_engine_equals_oracle_and_jax(case, monkeypatch):
    from abpoa_tpu_torch.align import engine_torch, export
    params = _case(case)
    if case == "overflow":
        monkeypatch.setattr(export, "pick_WB",
                            lambda params, qlen, pn: 2 * pn)
    engine_torch.reroutes.update(M_OVFL=0, M_FAIL=0)
    dp = _spy(monkeypatch)
    _run_all(_encoded("seq.fa"), params, "cpu")
    calls = len(_encoded("seq.fa")) - 1
    tile = params.wb >= 0 and params.align_mode != 1
    # the calls: B5 per banded global/extend call; B4 for the rest and
    # for every B5 overflow
    rerun = sum(engine_torch.reroutes.values())
    assert dp == {"tile_dp": calls if tile else 0,
                  "fw_dp": rerun if tile else calls}
    assert engine_torch.reroutes == {
        "M_OVFL": calls if case == "overflow" else 0, "M_FAIL": 0}


def test_engine_walk_dead_end_reruns_on_full_width(monkeypatch):
    """A B5 result with M_FAIL set re-runs on B4, on the same device,
    and gives the oracle's alignment; M_FAIL of B4 raises."""
    from abpoa_tpu_torch.align import engine_torch
    params = _case("global-convex")
    engine_torch.reroutes.update(M_OVFL=0, M_FAIL=0)
    dp = _spy(monkeypatch, flag_b5="M_FAIL")
    _run_all(_encoded("seq.fa"), params, "cpu")
    calls = len(_encoded("seq.fa")) - 1
    assert dp == {"tile_dp": calls, "fw_dp": calls}
    assert engine_torch.reroutes == {"M_OVFL": 0, "M_FAIL": calls}
    _spy(monkeypatch, flag_fw="M_FAIL")
    with pytest.raises(RuntimeError, match="backtrack"):
        _run_all(_encoded("seq.fa"), _case("local-convex"), "cpu")


def _long_read(k):
    """Reads k..k+6 of heter.fa joined: one read of 4.7-4.9 kb."""
    return np.concatenate(_encoded("heter.fa")[k:k + 7])


def test_engine_past_the_packed_step_word_equals_oracle():
    """A graph past 4096 nodes (one 4.8 kb read fused) and a second long
    read: the engine on the CPU (plain B5, rows past the 12 bits of the
    former step word) gives the JAX package oracle's score, cigar and
    band state."""
    from abpoa_tpu.align.engine_np import align_sequence_to_subgraph
    from abpoa_tpu.graph import POAGraph as JGraph
    from abpoa_tpu.params import Params as JParams
    from abpoa_tpu_torch import convert
    from abpoa_tpu_torch.align import engine_torch
    from abpoa_tpu_torch.graph import POAGraph
    from abpoa_tpu_torch.params import SRC_NODE_ID, SINK_NODE_ID
    jparams = JParams().post_set()
    tparams = convert.params(jparams)
    q0, q1 = _long_read(0), _long_read(1)
    gt, gj = POAGraph(), JGraph()
    gt.add_graph_alignment(tparams, q0, [1] * len(q0), [], None, 0, True)
    gj.add_graph_alignment(jparams, q0, [1] * len(q0), [], None, 0, True)
    gt.topological_sort(tparams)
    gj.topological_sort(jparams)
    assert gt.node_n > 4096
    engine_torch.reroutes.update(M_OVFL=0, M_FAIL=0)
    r_t = engine_torch.align_sequence_to_graph_device(gt, tparams, q1,
                                                      "cpu")
    r_j = align_sequence_to_subgraph(gj, jparams, SRC_NODE_ID,
                                     SINK_NODE_ID, q1)
    assert engine_torch.reroutes == {"M_OVFL": 0, "M_FAIL": 0}
    assert r_t.best_score == r_j.best_score
    assert list(map(tuple, r_t.cigar)) == list(map(tuple, r_j.cigar))
    assert (r_t.node_s, r_t.node_e, r_t.query_s, r_t.query_e) == (
        r_j.node_s, r_j.node_e, r_j.query_s, r_j.query_e)
    n = gt.node_n
    assert (np.array(gt.node_id_to_max_pos_left[:n])
            == np.array(gj.node_id_to_max_pos_left[:n])).all()
    assert (np.array(gt.node_id_to_max_pos_right[:n])
            == np.array(gj.node_id_to_max_pos_right[:n])).all()


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["global-convex", "extend-convex",
                                  "local-affine", "overflow"])
def test_engine_on_gpu_equals_oracle_and_jax(case, monkeypatch,
                                             cuda_device):
    from abpoa_tpu_torch.align import engine_torch, export
    params = _case(case)
    if case == "overflow":
        monkeypatch.setattr(export, "pick_WB",
                            lambda params, qlen, pn: 2 * pn)
    engine_torch.reroutes.update(M_OVFL=0, M_FAIL=0)
    _run_all(_encoded("seq.fa"), params, "cuda", against="cpu")
    assert engine_torch.reroutes["M_FAIL"] == 0
