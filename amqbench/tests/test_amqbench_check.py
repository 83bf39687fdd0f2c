"""The check that decides ``correct``: the program passes it, and the
control and every fault a cell can have fail it.  Small cells run the
whole harness on the CPU (the look for a card skipped), with the
program broken underneath where a test says so."""

import subprocess
import sys
import time

import pytest
import torch

from amqbench.harness import cell as runner
from amqbench.harness.engine import Control
from cells import SMALL, small_cell

import repro_torch.filters.qf_filter as qf_filter
import repro_torch.kernels.ops as kops

ROOT = __import__("pathlib").Path(__file__).resolve().parents[2]


def run(name, engine=None, seed=2**31 + 5, device="cpu"):
    cell = small_cell(name)
    if engine is not None:
        engine = engine(cell.config, device)
    result, lines = runner.run(cell, seed, 0.3, False, device, time.perf_counter(), engine)
    return result, lines


@pytest.mark.parametrize("name", sorted(SMALL))
def test_the_program_is_correct(name):
    result, lines = run(name)
    assert result["correct"] and result["failed"] == 0
    assert all(v["value"] == 0 and v["limit"] == 0 for v in result["check"].values())
    assert list(result)[-1] == "check"
    assert [ln.split()[1] for ln in lines if ln.startswith("check ")] == list(result["check"])


@pytest.mark.parametrize("name", sorted(SMALL))
def test_the_control_is_not(name):
    result, _ = run(name, engine=Control)
    assert not result["correct"]
    assert result["check"]["plane_mismatches"]["value"] > 0


def _unchanged(monkeypatch):
    monkeypatch.setattr(qf_filter, "insert_keys",
                        lambda core, backend, state, keys, k=None: state)


def _half(monkeypatch):
    real = qf_filter.insert_keys
    monkeypatch.setattr(qf_filter, "insert_keys",
                        lambda core, backend, state, keys, k=None:
                        real(core, backend, state, keys[: keys.shape[0] // 2], k))


def _altered(monkeypatch):
    """One remainder of every build, and one answer of every probe, changed
    where the kernel path produces it."""
    real_build, real_contains, real_cascade = kops.build_sorted, kops.contains, kops.cascade_lookup

    def build(cfg, fq, fr, n):
        st = real_build(cfg, fq, fr, n)
        rem = st.rem.clone()
        rem[int(torch.argmax(st.occ.to(torch.int32)))] ^= 1
        return st._replace(rem=rem)

    def contains(cfg, state, keys):
        hits = real_contains(cfg, state, keys).clone()
        hits[0] = ~hits[0]
        return hits

    def cascade(*args):
        hits = list(real_cascade(*args))
        hits[0] = hits[0].clone()
        hits[0][0] = ~hits[0][0]
        return tuple(hits)

    monkeypatch.setattr(kops, "build_sorted", build)
    monkeypatch.setattr(kops, "contains", contains)
    monkeypatch.setattr(kops, "cascade_lookup", cascade)


FAULTS = {"unchanged": _unchanged, "half_batch": _half, "altered": _altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", sorted(SMALL))
def test_every_fault_is_not_correct(monkeypatch, name, fault):
    FAULTS[fault](monkeypatch)
    result, _ = run(name)
    assert not result["correct"]
    assert result["failed"] > 0 or any(v["value"] for v in result["check"].values())


def test_without_a_card_the_run_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would run")
    proc = subprocess.run([sys.executable, "amqbench/run.py", "--workload", "qf-r12-q29.lookup",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 2 and proc.stdout == ""


@pytest.mark.card
@pytest.mark.parametrize("name", sorted(SMALL))
def test_small_cells_on_the_card(card, name):
    assert run(name, device=card)[0]["correct"]
    assert not run(name, engine=Control, device=card)[0]["correct"]


@pytest.mark.parametrize("whole", [True, False])
def test_a_window_of_whole_cycles_closes_at_a_cycles_end(whole):
    from amqbench.harness.engine import Port
    from amqbench.harness.trace import NoTracer
    from amqbench.harness.traffic import Traffic
    from amqbench.kinds import ingest

    cell = small_cell("cascade.ingest")
    traffic = Traffic(dict(cell.traffic, whole_cycles=whole), 3, "cpu")
    engine = Port(cell.config, "cpu")
    state, plan = ingest.setup(engine, engine.make(), traffic, [])
    _, record, outcome = ingest.window(engine, state, traffic, plan, 0.0, NoTracer())
    assert len(record.calls) == (traffic.cycle_batches if whole else 0)
    assert outcome["pos"] == len(record.calls)


def test_a_new_kind_is_a_new_file(tmp_path, monkeypatch):
    """A kind added as a module of its own, found by the mix's ``kind``,
    runs a cell with no other file changed."""
    import amqbench.kinds as kinds

    (tmp_path / "lookup_twice.py").write_text(
        "from amqbench.kinds.lookup import OP, PARAMS, validate, setup, window, expect\n"
    )
    monkeypatch.setattr(kinds, "__path__", [*kinds.__path__, str(tmp_path)])
    cell = small_cell("qf.lookup")
    cell = cell._replace(traffic=dict(cell.traffic, kind="lookup_twice"))
    result, _ = runner.run(cell, 11, 0.2, False, "cpu", time.perf_counter())
    assert result["correct"] and result["attempted"] > 0
