"""The port's attempt journal, startup crash policy, growth canary and the
``cli train --supervise`` restart loop, each case of
``tests/test_crash_recovery.py`` on the port (CPU), plus the journal a JAX
run wrote read by the port and the crash policy's decisions held equal to
the JAX trainer's on the same journal.

On CUDA an out-of-memory error is an exception, which the growth canary
reverts; a lost context (an illegal address, a launch failure) is
re-raised for the supervisor, and the journal names the configuration in
flight."""

import dataclasses
import signal
from pathlib import Path

import pytest
import torch

from qed_splatter_tpu.configs import DataConfig as JData
from qed_splatter_tpu.configs import ModelConfig as JModel
from qed_splatter_tpu.configs import TrainerConfig as JTrainerConfig
from qed_splatter_tpu.engine.journal import AttemptJournal as JJournal
from qed_splatter_tpu.engine.trainer import Trainer as JTrainer
from qed_splatter_tpu_torch import testing as ttesting
from qed_splatter_tpu_torch.configs import DataConfig, ModelConfig, \
    TrainerConfig
from qed_splatter_tpu_torch.engine import checkpoint as ckpt
from qed_splatter_tpu_torch.engine.journal import AttemptJournal
from qed_splatter_tpu_torch.engine.trainer import Trainer

REPO = Path(__file__).resolve().parents[1]
MODEL_KW = dict(camera_opt_mode="off", max_per_tile=64, num_downscales=0,
                warmup_length=10, refine_every=10, init_capacity_headroom=1.2)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("scene")
    ttesting.write_synthetic_dataset(root, num_frames=5, width=64, height=48,
                                     with_ply=True)
    return root


def _cfg(dataset, tmp_path, model_kw=None, jax=False, **kw):
    mk = {**MODEL_KW, **(model_kw or {})}
    args = dict(max_num_iterations=40, steps_per_eval_image=0,
                steps_per_eval_all_images=0, steps_per_save=10, log_every=10,
                output_dir=str(tmp_path), **kw)
    if jax:
        return JTrainerConfig(data=JData(data=str(dataset)),
                              model=JModel(**mk), **args)
    return TrainerConfig(data=DataConfig(data=str(dataset)),
                         model=ModelConfig(**mk), **args)


def _journal(cfg) -> AttemptJournal:
    return AttemptJournal(Path(cfg.output_dir) / (cfg.experiment_name
                                                  or "qed-splatter")
                          / "attempt_journal.jsonl")


def _fill(trainer, share=0.9):
    """Mark ``share`` of the slots alive: the growth trigger."""
    alive = torch.zeros(trainer.state.params.capacity, dtype=torch.bool)
    alive[: int(share * alive.numel())] = True
    trainer.state.params.alive.copy_(alive)


# ------------------------------------------------------------ journal unit


def test_journal_matched_and_unmatched(tmp_path):
    j = AttemptJournal(tmp_path / "j.jsonl")
    assert j.crashed() == []
    j.attempt(kind="step", capacity=100, d=1, k=512)
    j.ok(kind="step", capacity=100, d=1, k=512)
    assert j.crashed() == []
    j.attempt(kind="step", capacity=200, d=1, k=512)
    crashed = j.crashed()
    assert len(crashed) == 1 and crashed[0]["capacity"] == 200
    # unmatched attempts accumulate across crashes and are never cleared
    j.attempt(kind="eval", capacity=100, k=1024, w=64, h=48)
    assert len(j.crashed()) == 2


def test_journal_crash_counts(tmp_path):
    """attempt / ok / attempt-and-die counts one crash; the same
    configuration dying again counts two."""
    j = AttemptJournal(tmp_path / "j.jsonl")
    key = dict(kind="step", capacity=200, d=1, k=512)
    j.attempt(**key)
    j.ok(**key)
    j.attempt(**key)
    [(rec, n)] = j.crashed_with_counts()
    assert rec["capacity"] == 200 and n == 1
    j.attempt(**key)
    [(rec, n)] = j.crashed_with_counts()
    assert n == 2


def test_journal_survives_torn_tail_write(tmp_path):
    j = AttemptJournal(tmp_path / "j.jsonl")
    j.attempt(kind="step", capacity=100, d=1, k=512)
    with open(j.path, "a") as fh:
        fh.write('{"event": "ok", "kind": "st')  # killed mid-append
    crashed = j.crashed()
    assert len(crashed) == 1 and crashed[0]["capacity"] == 100


def test_journal_reads_what_jax_wrote(tmp_path):
    """A journal the JAX package's ``AttemptJournal`` wrote, torn tail
    included, reads to the same ``crashed_with_counts`` in the port."""
    jj = JJournal(tmp_path / "j.jsonl")
    recs = [dict(kind="step", capacity=100, d=2, k=256, chunk=10),
            dict(kind="refine", capacity=100, max_hw=64),
            dict(kind="eval", capacity=200, k=1024, w=64, h=48),
            dict(kind="step", capacity=200, d=1, k=512, w=64, h=48,
                 sharded=False)]
    for i, r in enumerate(recs):
        for _ in range(i % 3 + 1):
            jj.attempt(**r)
        if i % 2 == 0:
            jj.ok(**r)
    with open(jj.path, "a") as fh:
        fh.write('{"event": "attempt", "kind": "re')
    port = AttemptJournal(jj.path)
    assert port.records() == jj.records()
    assert port.crashed_with_counts() == jj.crashed_with_counts()
    assert port.crashed() == jj.crashed()
    assert len(port.crashed()) == 3


# ----------------------------------------------------- startup crash policy


def test_crash_policy_refuses_crashed_capacity(dataset, tmp_path):
    """An unmatched attempt at a capacity above the restored one: that
    growth killed the process, and it is refused on every start."""
    cfg = _cfg(dataset, tmp_path)
    cap = Trainer(cfg, device="cpu").state.params.capacity
    j = _journal(cfg)
    # two crashes: past the default journal_retry=1 amnesty
    j.attempt(kind="step", capacity=2 * cap, d=1, k=64, chunk=10)
    j.attempt(kind="step", capacity=2 * cap, d=1, k=64, chunk=10)
    t = Trainer(cfg, device="cpu")
    assert (2 * cap) in t._grow_refused
    t2 = Trainer(cfg, device="cpu")
    assert (2 * cap) in t2._grow_refused
    # the refused growth is never attempted, even when triggered
    _fill(t2)
    assert not t2._maybe_grow(0, 64)
    assert t2.state.params.capacity == cap


def test_crash_policy_caps_bucket_k(dataset, tmp_path):
    """An unmatched step attempt at the current capacity with a given
    (d, K): that bucket's K is capped below it, and adaptive growth cannot
    reach it again."""
    cfg = _cfg(dataset, tmp_path)
    cap = Trainer(cfg, device="cpu").state.params.capacity
    j = _journal(cfg)
    j.attempt(kind="step", capacity=cap, d=1, k=512, chunk=10)
    j.attempt(kind="step", capacity=cap, d=1, k=512, chunk=10)
    t = Trainer(cfg, device="cpu")
    assert t._k_crash_cap[1] == 256
    assert t._k_for(1) <= 256
    t._k_by_d[1] = 256
    t._maybe_adapt_k(overflow=10 ** 9, max_count=None, width=64, height=48,
                     d=1)
    assert t._k_for(1) <= 256


def test_crash_policy_caps_eval_k(dataset, tmp_path):
    cfg = _cfg(dataset, tmp_path)
    cap = Trainer(cfg, device="cpu").state.params.capacity
    j = _journal(cfg)
    j.attempt(kind="eval", capacity=cap, k=2048, w=64, h=48)
    j.attempt(kind="eval", capacity=cap, k=2048, w=64, h=48)
    t = Trainer(cfg, device="cpu")
    assert t._eval_k_cap == 1024
    assert t._k_eval(1) <= 1024
    m = t.eval_image(0)
    assert m["eval_k_cap"] == 1024


def test_crash_policy_amnesty_then_permanent_refusal(dataset, tmp_path):
    """One crash is granted amnesty under journal_retry=1; the same
    configuration dying again is refused on every later start."""
    cfg = _cfg(dataset, tmp_path)
    cap = Trainer(cfg, device="cpu").state.params.capacity
    j = _journal(cfg)
    j.attempt(kind="step", capacity=2 * cap, d=1, k=64, chunk=10)
    assert (2 * cap) not in Trainer(cfg, device="cpu")._grow_refused
    j.attempt(kind="step", capacity=2 * cap, d=1, k=64, chunk=10)
    assert (2 * cap) in Trainer(cfg, device="cpu")._grow_refused
    assert (2 * cap) in Trainer(cfg, device="cpu")._grow_refused


def test_crash_policy_journal_retry_zero_is_strict(dataset, tmp_path):
    cfg = dataclasses.replace(_cfg(dataset, tmp_path), journal_retry=0)
    cap = Trainer(cfg, device="cpu").state.params.capacity
    _journal(cfg).attempt(kind="step", capacity=2 * cap, d=1, k=64,
                          chunk=10)
    assert (2 * cap) in Trainer(cfg, device="cpu")._grow_refused


@pytest.mark.parametrize("case", ["capacity", "step_k", "eval_k", "refine",
                                  "amnesty", "strict"])
def test_crash_policy_decisions_equal_jax(dataset, tmp_path, case):
    """The same journal in both packages' run directories: the port's
    refusals, K caps, eval cap and densification freeze equal the JAX
    trainer's."""
    kw = dict(journal_retry=0) if case == "strict" else {}
    tcfg = _cfg(dataset, tmp_path / "t", **kw)
    jcfg = _cfg(dataset, tmp_path / "j", jax=True, **kw)
    cap = Trainer(tcfg, device="cpu").state.params.capacity
    rec = {"capacity": dict(kind="step", capacity=2 * cap, d=1, k=64,
                            chunk=10),
           "step_k": dict(kind="step", capacity=cap, d=1, k=1024, chunk=10),
           "eval_k": dict(kind="eval", capacity=cap, k=512, w=64, h=48),
           "refine": dict(kind="refine", capacity=cap, max_hw=64),
           "amnesty": dict(kind="step", capacity=cap, d=1, k=1024,
                           chunk=10),
           "strict": dict(kind="refine", capacity=cap, max_hw=64)}[case]
    for cfg in (tcfg, jcfg):
        j = _journal(cfg)
        for _ in range(1 if case in ("amnesty", "strict") else 2):
            j.attempt(**rec)
    t, jt = Trainer(tcfg, device="cpu"), JTrainer(jcfg)
    assert t.state.params.capacity == int(jt.state.params.capacity) == cap
    assert t._grow_refused == jt._grow_refused
    assert t._k_crash_cap == jt._k_crash_cap
    assert t._eval_k_cap == jt._eval_k_cap
    assert t._densify_frozen_until == jt._densify_frozen_until
    assert t._k_for(1) == jt._k_for(1) and t._k_eval(1) == jt._k_eval(1)
    changed = (t._grow_refused, t._k_crash_cap, t._eval_k_cap,
               t._densify_frozen_until)
    assert (changed == (set(), {}, None, 0)) == (case == "amnesty")


# ------------------------------------------------------ journaled dispatch


def test_dispatch_journal_witnesses_new_configs(dataset, tmp_path):
    """Every new configuration leaves an attempt / ok pair; a repeated one
    adds nothing."""
    cfg = _cfg(dataset, tmp_path, steps_per_dispatch=10,
               model_kw=dict(adaptive_max_per_tile=False, warmup_length=100))
    t = Trainer(cfg, device="cpu")
    t.train(max_steps=20, finalize=False)
    steps = [r for r in t._journal.records() if r["kind"] == "step"]
    # 2 identical chunks (no refine, fixed K): one graph, one pair
    assert [r["event"] for r in steps] == ["attempt", "ok"]
    assert steps[0]["chunk"] == 10 and t._journal.crashed() == []
    # a refine and K growth open new witnesses
    cfg2 = _cfg(dataset, tmp_path, steps_per_dispatch=10,
                experiment_name="j2", model_kw=dict(max_per_tile_limit=128))
    t2 = Trainer(cfg2, device="cpu")
    t2.train(max_steps=20, finalize=False)
    recs = t2._journal.records()
    assert any(r["kind"] == "refine" for r in recs)
    assert t2._journal.crashed() == []
    att = [r for r in recs if r["event"] == "attempt"]
    oks = [r for r in recs if r["event"] == "ok"]
    assert [dict(r, event="ok") for r in att] == oks[:len(att)] == oks


# -------------------------------------------------------- growth canary


def test_growth_canary_failure_reverts_and_refuses(dataset, tmp_path):
    """The first dispatch at a grown capacity runs out of memory: the
    pre-growth state comes back, the capacity is refused, the run goes
    on."""
    cfg = _cfg(dataset, tmp_path, steps_per_dispatch=10,
               model_kw=dict(adaptive_max_per_tile=False))
    t = Trainer(cfg, device="cpu")
    t.train(max_steps=10, finalize=False)
    cap = t.state.params.capacity
    _fill(t)
    orig = t._dispatch_journaled

    def failing(key, fn, *args):
        if int(key.get("capacity", 0)) == 2 * cap:
            raise torch.cuda.OutOfMemoryError("simulated post-growth OOM")
        return orig(key, fn, *args)

    t._dispatch_journaled = failing
    t.train(max_steps=20, finalize=False)       # the refine at 20 grows
    assert t.state.params.capacity == cap
    assert (2 * cap) in t._grow_refused
    assert t.state.step == 20
    assert bool(torch.isfinite(t.state.params.means).all())


def test_growth_canary_device_loss_reraises(dataset, tmp_path):
    """A lost CUDA context cannot be recovered in the process: it is
    re-raised for the supervisor, and the journal witnesses the
    configuration."""
    cfg = _cfg(dataset, tmp_path, steps_per_dispatch=10,
               model_kw=dict(adaptive_max_per_tile=False))
    t = Trainer(cfg, device="cpu")
    t.train(max_steps=10, finalize=False)
    cap = t.state.params.capacity
    _fill(t)
    orig = t._dispatch_journaled

    def dying(key, fn, *args):
        if int(key.get("capacity", 0)) == 2 * cap:
            if key.get("kind") == "refine":
                t._journal.attempt(**key)  # the witness a real death leaves
            raise RuntimeError("CUDA error: an illegal memory access was "
                               "encountered")
        return orig(key, fn, *args)

    t._dispatch_journaled = dying
    with pytest.raises(RuntimeError, match="illegal memory access"):
        t.train(max_steps=20, finalize=False)
    # first death: the restart grants amnesty (journal_retry=1)
    assert (2 * cap) not in Trainer(cfg, device="cpu")._grow_refused
    [crashed] = t._journal.crashed()
    t._journal.attempt(**{k: v for k, v in crashed.items() if k != "event"})
    assert (2 * cap) in Trainer(cfg, device="cpu")._grow_refused


# ------------------------------------------------------------- supervisor


class _Timeout(Exception):
    pass


def _supervise(capfd, monkeypatch, *args, crash_at, timeout):
    """``cli train --supervise`` in this process (its children are
    processes), under its own timeout: an alarm raises inside the wait,
    and ``subprocess.call`` kills the child it waits for."""
    from qed_splatter_tpu_torch.cli import main

    def expire(*_):
        raise _Timeout(f"the supervised run took more than {timeout} s")

    monkeypatch.setenv("QED_CRASH_ONCE_AT", str(crash_at))
    # one thread a child: the suite's workers already use every core
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.chdir(REPO)
    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(timeout)
    try:
        rc = main(["train", "--device", "cpu", *args, "--supervise"])
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)
    out, err = capfd.readouterr()
    return rc, out, err


def test_supervisor_restarts_after_a_lost_process(dataset, tmp_path, capfd,
                                                  monkeypatch):
    """A child that dies by a hard exit (``QED_CRASH_ONCE_AT``) is
    restarted by ``train --supervise`` from the last checkpoint, and the
    run completes; the journal holds matched records only."""
    rc, out, err = _supervise(
        capfd, monkeypatch, "--data", str(dataset),
        "--max-num-iterations", "10", "--steps-per-save", "5",
        "--steps-per-eval-image", "0", "--steps-per-eval-all-images", "0",
        "--log-every", "5", "--steps-per-dispatch", "5", "--output-dir",
        str(tmp_path), "--experiment-name", "supervised", "--vis", "none",
        "--max-restarts", "2", "--model.camera-opt-mode", "off",
        "--model.max-per-tile", "64", "--no-model.adaptive-max-per-tile",
        "--model.num-downscales", "0", "--model.warmup-length", "100",
        "--model.refine-every", "50", crash_at=8, timeout=300)
    assert rc == 0, out[-2000:] + err[-2000:]
    assert out.count("TEST HOOK: simulating a lost process") == 1
    assert out.count("SUPERVISOR: training process exited") == 1
    assert "Resumed from" in out and "step-000000005 at step 5" in out
    run = tmp_path / "supervised"
    assert ckpt.latest_checkpoint(run / "ckpts").name == "step-000000010"
    j = AttemptJournal(run / "attempt_journal.jsonl")
    assert j.records() and j.crashed() == []


def test_supervisor_stops_on_persistent_failure(tmp_path, capfd,
                                                monkeypatch):
    """A child that fails at once with no checkpoint progress does not
    spin: the supervisor stops after two such failures."""
    rc, out, err = _supervise(
        capfd, monkeypatch, "--data", str(tmp_path / "does-not-exist"),
        "--output-dir", str(tmp_path), "--experiment-name", "doomed",
        "--vis", "none", "--max-restarts", "5", crash_at=0, timeout=120)
    assert rc != 0
    assert out.count("SUPERVISOR: training process exited") <= 2
    assert "no checkpoint progress" in err


def test_canary_kinds():
    """Which errors the growth canary reverts and which mean a lost
    device."""
    oom = torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to "
                                      "allocate 2.00 GiB")
    lost = RuntimeError("CUDA error: unspecified launch failure")
    assert Trainer._canary_reverts(oom)
    assert Trainer._canary_reverts(RuntimeError("CUDA error: out of memory"))
    assert not Trainer._canary_reverts(lost) and Trainer._device_lost(lost)
    assert not Trainer._canary_reverts(ValueError("shape"))
    assert Trainer._device_lost(RuntimeError(
        "CUDA error: device-side assert triggered"))
    assert not Trainer._device_lost(oom)
