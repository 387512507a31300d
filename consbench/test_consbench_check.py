"""The check that decides `correct`: the control (the reference in int8
in the program's place) fails it, and a run on the port's plain versions
(the CPU) passes it and fails with the timed path broken underneath."""
import pytest

from consbench import control, run

DEFAULT = {"params": {"wb": 10, "wf": 0.01, "disable_seeding": True}}
ERRORS = {"sub": 0.004, "ins": 0.002, "del": 0.004}


def traffic(driver, schedule, batches=2, check=3):
    return {"driver": driver, "schedule": schedule, "batches": batches,
            "errors": ERRORS, "check_clusters": check}


@pytest.mark.parametrize("driver", ["batch", "cli"])
def test_control_is_not_correct(driver):
    t = traffic(driver, [[300, 4], [260, 5], [340, 3]])
    checks = control.control_checks(DEFAULT, t, 2**31 + 11)
    assert checks["checked_answers"] == 3
    assert checks["wrong_answers"] >= 1


def test_reference_in_the_programs_place_is_correct():
    t = traffic("batch", [[300, 4], [260, 5]])
    pool = run.gen.make_pool(7, t)
    sample = [(0, 0), (1, 1)]
    refs = run.reference([(DEFAULT["params"], 0, pool[b][k])
                          for b, k in sample], 1)
    expected = {cid: cons for cid, (cons, _c) in zip(sample, refs)}
    calls = [run.Call(0, 0, [cid], [cons], {})
             for cid, (cons, _c) in zip(sample, refs)]
    checks = run.compare(calls, expected, list)
    assert checks["wrong_answers"] == 0 and checks["checked_answers"] == 2


def alter_first(answers):
    """The first answer with its first consensus base changed."""
    a = answers[0]
    if isinstance(a, str):      # the CLI's file text
        i = a.index("\n") + 1
        return [a[:i] + ("C" if a[i] != "C" else "G") + a[i + 1:]]
    s = a[0]
    return [[("C" if s[0] != "C" else "G") + s[1:]]] + list(answers[1:])


def cpu_run(driver, fault=None, monkeypatch=None):
    t = traffic(driver, [[120, 3], [100, 4], [140, 3]], check=6)
    if fault == "altered" and driver == "batch":
        from abpoa_tpu_torch.parallel.batch import BatchPOA
        orig = BatchPOA.run_consensus
        monkeypatch.setattr(BatchPOA, "run_consensus",
                            lambda self, *a, **k: alter_first(
                                orig(self, *a, **k)))
    elif fault == "altered":
        from abpoa_tpu_torch import api
        orig_g = api.generate_consensus

        def altered(ab, params):
            orig_g(ab, params)
            c = ab.cons.cons_base[0]
            c[0] = (c[0] + 1) % 4
        monkeypatch.setattr(api, "generate_consensus", altered)
    elif fault == "half":
        from abpoa_tpu_torch.parallel.batch import BatchPOA
        orig = BatchPOA.run_consensus
        monkeypatch.setattr(BatchPOA, "run_consensus",
                            lambda self, inst, **k: orig(
                                self, inst[:len(inst) // 2], **k))
    result, window, checks = run.run_cell(
        {"name": "t", "chips": 1}, DEFAULT, t, 2**31 + 5, 0.2, False,
        "cpu", workers=1)
    return result, checks


@pytest.mark.parametrize("driver", ["batch", "cli"])
def test_cpu_run_is_correct(driver):
    result, checks = cpu_run(driver)
    assert result["correct"] and result["failed"] == 0
    assert checks["checked_answers"] >= 1


@pytest.mark.parametrize("driver,fault", [("batch", "altered"),
                                          ("batch", "half"),
                                          ("cli", "altered")])
def test_broken_timed_path_is_not_correct(driver, fault, monkeypatch):
    result, checks = cpu_run(driver, fault, monkeypatch)
    assert not result["correct"] and result["failed"] >= 1
