"""The port's open-loop load generator (``repro_torch.loadgen``) against
the JAX package's ``repro.loadgen``, on the CPU.

Arrival schedules are pure functions of (parameters, seed), and the
model-clock harness measures admission, expiry and latency on a fake
clock priced by the DSE report, so both packages must give the same
numbers bit for bit: no tolerance anywhere in this file. The scenarios
are the JAX package's published ones (``benchmarks/load_harness.py``,
``chaos_harness.py``, ``elastic_harness.py``: yolov3-tiny at 64,
batch 4), and the port alone reproduces their three headline figures.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.loadgen as jlg
import repro.serve as jserve
import repro_torch.core as tcore
import repro_torch.loadgen as tlg
import repro_torch.serve as tserve
from repro.core import codegen as jcg
from repro.models import yolo as jyolo
from repro_torch.models import yolo as tyolo

IMG, BATCH, SLO_STEPS, SEEDS = 64, 4, 6, (0, 1, 2)
LEVELS = (0.5, 0.75, 1.0, 1.5, 2.0)
KNEE_RPS = 5704.059151093396            # BENCH_load.json knee
KILL_GOODPUT_RPS = 3285.9520561102354   # BENCH_chaos.json headline
WEIGHTED_VS_RR = 1.0585665819815344     # BENCH_elastic.json headline


def test_exports_match_the_jax_package():
    want = {n for n in dir(jlg) if not n.startswith("_")} - {
        "arrival", "harness", "metrics", "report"}
    assert want <= set(dir(tlg))


# ----------------------------------------------------------- arrivals

PROCESSES = {
    "constant": lambda m, s: m.ConstantArrivals(rate=700.0, seed=s),
    "poisson": lambda m, s: m.PoissonArrivals(rate=900.0, seed=s),
    "diurnal": lambda m, s: m.DiurnalPoissonArrivals(
        base_rate=100.0, peak_rate=1500.0, period_s=0.4, seed=s),
    "grouped": lambda m, s: m.GroupedArrivals(
        m.PoissonArrivals(rate=250.0, seed=s), 4),
    "burst": lambda m, s: m.OnOffBurstArrivals(
        rate_on=1800.0, on_s=0.07, off_s=0.11, rate_off=60.0, seed=s),
}


@pytest.mark.parametrize("seed", (0, 7, 123456789))
@pytest.mark.parametrize("name", sorted(PROCESSES))
def test_arrival_schedules_equal_bit_for_bit(name, seed):
    tp, jp = PROCESSES[name](tlg, seed), PROCESSES[name](jlg, seed)
    for slo_ms in (None, 12.5):
        got = [dataclasses.astuple(a)
               for a in tp.schedule(1.0, slo_ms=slo_ms, start_uid=3)]
        want = [dataclasses.astuple(a)
                for a in jp.schedule(1.0, slo_ms=slo_ms, start_uid=3)]
        assert len(got) > 20
        assert got == want
    assert tp.describe() == jp.describe()
    assert tp.mean_rate() == jp.mean_rate()


# ------------------------------------------------------------ metrics

def _fake_runs(m, seed: int):
    """Eight seeded fake runs of rising offered load, folded by the
    package ``m``'s own ``summarize``."""
    rng = np.random.default_rng((seed, 0x10AD))
    out = []
    for i in range(8):
        offered = 100.0 * (i + 1) + float(rng.uniform(0, 50))
        n = int(offered)
        frac = float(min(1.0, 1.3 - 0.15 * i + rng.uniform(-0.05, 0.05)))
        adm = int(n * frac)
        lat = [float(v) for v in rng.exponential(0.01, size=adm)]
        out.append(m.summarize(
            offered_rps=offered, duration_s=1.0,
            makespan_s=1.0 + float(rng.uniform(0, 0.3)), n_offered=n,
            sched_stats={"admitted": adm, "rejected": n - adm,
                         "expired": int(rng.integers(0, 3))},
            completions_s=lat, on_deadline=int(adm * 0.97),
            batches=int(rng.integers(5, 50)),
            utilization=float(rng.uniform(0, 1)), clock="model",
            process={"process": "fake", "seed": seed},
            failed=int(rng.integers(0, 2)), extras={"i": i}))
    return out


def _events(seed: int):
    rng = np.random.default_rng((seed, 0xE7E7))
    ts = np.sort(rng.uniform(0.0, 2.3, size=400))
    return [(float(t), bool(ok)) for t, ok in
            zip(ts, rng.uniform(size=ts.size) < 0.93)]


@pytest.mark.parametrize("seed", SEEDS)
def test_summarize_and_find_knee_equal(seed):
    tr, jr = _fake_runs(tlg, seed), _fake_runs(jlg, seed)
    assert [r.to_row() for r in tr] == [r.to_row() for r in jr]
    for floor in (0.9, 0.75):
        assert tlg.find_knee(tr, floor) == jlg.find_knee(jr, floor)
    lat = [float(v) for v in np.random.default_rng(seed).exponential(
        0.02, size=37)]
    for p in (0, 50, 95, 99, 100):
        assert tlg.percentile(sorted(lat), p) == \
            jlg.percentile(sorted(lat), p)
    assert tlg.latency_summary(lat) == jlg.latency_summary(lat)
    rates = [r.rejected_rate for r in tr]
    for tol in (0.0, 0.01):
        assert tlg.monotone_nondecreasing(rates, tol) == \
            jlg.monotone_nondecreasing(rates, tol)


@pytest.mark.parametrize("seed", SEEDS)
def test_windowed_on_time_and_ramp_ok_equal(seed):
    ev = _events(seed)
    for window_s, duration_s in ((0.25, None), (0.3, 3.0), (1.0, 2.0)):
        tw = tlg.windowed_on_time(ev, window_s, duration_s=duration_s)
        assert tw == jlg.windowed_on_time(ev, window_s,
                                          duration_s=duration_s)
        for floor, transient in ((0.9, frozenset()), (0.95, {0, 2})):
            assert tlg.ramp_ok(tw, floor, transient) == \
                jlg.ramp_ok(tw, floor, transient)


@pytest.mark.parametrize("seed", SEEDS)
def test_payload_and_table_equal(seed):
    tr, jr = _fake_runs(tlg, seed), _fake_runs(jlg, seed)
    cfg = {"model": "fake", "seed": seed}
    kw = dict(config=cfg, quick=bool(seed % 2),
              processes=[{"p": seed}], wall=[{"w": 1}])
    assert tlg.payload(tr, tlg.find_knee(tr), **kw) == \
        jlg.payload(jr, jlg.find_knee(jr), **kw)
    assert tlg.render_table(tr) == jlg.render_table(jr)


# ---------------------------------- the harness on the model clock

def _first_pixel(params, x):
    """A stand-in executor: one output, cut from the batch."""
    return [x[:, :1, :1, :1]]


def _published_runs(m, serve, acc, **kw) -> dict:
    """The JAX package's three published scenarios, run by the package
    ``m`` over ``acc``: the saturation sweep, the replica-0 crash at
    step 16 (retry budget 2 and 0), and the elastic rows (weighted and
    round-robin dispatch over a 2x-slow replica 0, three seeds; the
    diurnal autoscale ramp). The replicas serve through
    ``_first_pixel``, memoised as the accelerator's step: on the model
    clock no row reads an output
    (``test_model_clock_rows_do_not_read_outputs``), and the compiled
    executors would take minutes on the CPU beside other test
    processes."""
    acc._step_fns = {None: _first_pixel}
    step = float(acc.report["batched_latency_ms"])
    h = m.OpenLoopHarness(acc, replicas=2, batch_size=BATCH,
                          slo_ms=SLO_STEPS * step, step_ms=step, seed=0,
                          **kw)
    sweep, knee = h.sweep(levels=LEVELS, rounds=48, seed=0)
    out = {"sweep": [r.to_row() for r in sweep], "knee": knee}
    for budget in (2, 0):
        plan = serve.FaultPlan(
            [serve.FaultEvent(replica=0, kind="crash", step=16)], seed=0)
        h = m.OpenLoopHarness(acc, replicas=2, batch_size=BATCH,
                              slo_ms=SLO_STEPS * step, step_ms=step,
                              seed=0, fault_plan=plan, retry_budget=budget,
                              **kw)
        r = h.run(m.PoissonArrivals(rate=0.9 * h.capacity_rps(), seed=0),
                  48 * h.step_s, clock="model")
        out[f"kill_{budget}"] = r.to_row()
    for policy in ("rr", "weighted"):
        for seed in SEEDS:
            h = m.ElasticHarness(acc, replicas=2, batch_size=BATCH,
                                 slo_ms=3 * step, step_ms=step,
                                 dispatch=policy,
                                 step_ms_by_index={0: 2.0 * step, 1: step},
                                 seed=seed, **kw)
            proc = m.GroupedArrivals(m.PoissonArrivals(
                rate=0.85 * h.capacity_rps() / BATCH, seed=seed), BATCH)
            out[f"{policy}_{seed}"] = h.run_elastic(
                proc, 32 * h.step_s).to_row()
    h = m.ElasticHarness(acc, replicas=1, batch_size=BATCH,
                         slo_ms=SLO_STEPS * step, step_ms=step,
                         autoscale=dict(min_replicas=1, max_replicas=4),
                         seed=0, **kw)
    cap = h.capacity_rps()
    out["ramp"] = h.run_elastic(m.DiurnalPoissonArrivals(
        base_rate=0.3 * cap, peak_rate=4.0 * cap, period_s=48 * h.step_s,
        seed=0), 48 * h.step_s).to_row()
    return out


def _port_acc():
    return tcore.compile(tyolo.build("yolov3-tiny", IMG),
                         tcore.CompileConfig(batch_size=BATCH),
                         torch_device="cpu")


@pytest.fixture
def one_thread():
    """One torch thread while the port's compiled executors run: beside
    other test processes on the same cores, torch's thread pool
    oversubscribes them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def port_runs():
    return _published_runs(tlg, tserve, _port_acc(), devices=["cpu"])


@pytest.fixture(scope="module")
def jax_runs():
    # the weights do not enter a row: one jitted draw, not one a layer
    model = jyolo.build("yolov3-tiny", IMG)
    params = jax.jit(lambda k: jcg.init_params(model.graph, k))(
        jax.random.PRNGKey(0))
    acc = jcore.compile(model, jcore.CompileConfig(batch_size=BATCH),
                        params=params)
    return _published_runs(jlg, jserve, acc)


def test_model_clock_rows_do_not_read_outputs(one_thread):
    """One model-clock run served by the compiled executors and by
    ``_first_pixel`` gives the same row."""
    acc = _port_acc()
    step = float(acc.report["batched_latency_ms"])

    def row():
        h = tlg.OpenLoopHarness(acc, replicas=2, batch_size=BATCH,
                                slo_ms=SLO_STEPS * step, step_ms=step,
                                seed=0, devices=["cpu"])
        return h.run(tlg.PoissonArrivals(rate=1.5 * h.capacity_rps(),
                                         seed=4), 12 * h.step_s).to_row()
    real = row()
    acc._step_fns = {None: _first_pixel}
    assert row() == real


@pytest.mark.parametrize("level", range(len(LEVELS)))
def test_sweep_rows_equal_jax(port_runs, jax_runs, level):
    assert port_runs["sweep"][level] == jax_runs["sweep"][level]


@pytest.mark.parametrize("key", ["kill_2", "kill_0", "ramp"] + [
    f"{p}_{s}" for p in ("rr", "weighted") for s in SEEDS])
def test_fault_and_elastic_rows_equal_jax(port_runs, jax_runs, key):
    row = port_runs[key]
    assert row == jax_runs[key]
    # every admitted request lands in exactly one bucket
    assert row["admitted"] == row["completed"] + row["expired"] \
        + row["failed"]


def _mean_goodput(runs: dict, policy: str) -> float:
    # summed left to right as ``elastic_harness`` does (Python's
    # ``sum`` of floats compensates, and differs in the last bit)
    total = 0.0
    for seed in SEEDS:
        total += runs[f"{policy}_{seed}"]["goodput_rps"]
    return total / len(SEEDS)


def test_port_reproduces_the_published_figures(port_runs, jax_runs):
    assert port_runs["knee"] == jax_runs["knee"]
    assert port_runs["knee"]["knee_offered_rps"] == KNEE_RPS
    assert port_runs["kill_2"]["goodput_rps"] == KILL_GOODPUT_RPS
    assert _mean_goodput(port_runs, "weighted") \
        / _mean_goodput(port_runs, "rr") == WEIGHTED_VS_RR
    ramp = port_runs["ramp"]
    assert ramp["replicas_hwm"] >= 2
    assert ramp["replicas_final"] < ramp["replicas_hwm"]


# ---------------------------------- the harness on the wall clock

def test_wall_clock_run_on_the_cpu(one_thread):
    """The wall path's mechanics (warm-up, late submits, drain, ledger)
    on the CPU at a light load; its times are the host's, not a
    device's."""
    acc = tcore.compile(tyolo.build("yolov3-tiny", 32),
                        tcore.CompileConfig(batch_size=2),
                        torch_device="cpu")
    h = tlg.OpenLoopHarness(acc, replicas=2, batch_size=2, step_ms=40.0,
                            slo_ms=400.0, seed=0, devices=["cpu"])
    r = h.run(tlg.PoissonArrivals(rate=0.3 * h.capacity_rps(), seed=0),
              0.3, clock="wall")
    assert r.clock == "wall" and r.n_offered > 0
    assert r.admitted + r.rejected == r.n_offered
    assert r.admitted == r.completed + r.expired + r.failed
    assert r.extras["max_submit_lag_ms"] >= 0.0
    assert r.extras["rounds"] >= 1
