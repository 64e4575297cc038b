"""The port's SSMEngine against the JAX SSMEngine, stream for stream, and
the recurrent-state lifecycle of ``tests/test_ssm_engine.py``.

Both engines serve the same requests on the same weights (reduced
mamba2-1.3b, f32, the JAX parameters carried across by ``params_from_jax``;
the port on the CPU). Greedy and seeded top-k/top-p streams must be
byte-identical, with the same number of prefill chunks and decode steps.
The pure-SSM arms of the JAX engine's unit suite are ported: the bank's
snapshot/restore round trip, no state leak from a recycled slot, discard
and snapshot preemption byte-identical to an undisturbed run (and to the
JAX stream), youngest-decoder choice. Also runs the port's serve driver on
mamba2 end to end, and checks that the hybrid family builds and serves
(its streams against JAX's: ``tests/test_torch_hybrid_engine.py``).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.configs import ARCHS as JARCHS, reduced as jreduced  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import SamplingParams as JSamplingParams  # noqa: E402
from repro.serving import SSMEngine as JSSMEngine  # noqa: E402
from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.models import params_from_jax  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    FinishReason,
    Request,
    SamplingParams,
    SlotStateBank,
    SSMEngine,
)

REPO = Path(__file__).resolve().parents[1]
SAMPLED = dict(temperature=0.9, seed=7, max_new_tokens=10, top_k=30)
PREEMPT_PROMPT = [9, 8, 7, 6]


@pytest.fixture(scope="module")
def weights():
    jcfg = jreduced(JARCHS["mamba2-1.3b"])
    jparams = jbuild(jcfg).init(jax.random.key(0))
    cfg = reduced(ARCHS["mamba2-1.3b"])
    state = params_from_jax(cfg, jax.tree.map(np.asarray, jparams))
    return jcfg, jparams, cfg, state


def _engine(weights, **kw):
    _, _, cfg, state = weights
    return SSMEngine(cfg, state, device="cpu", **kw)


def drain(engine):
    while not engine.idle:
        engine.step()


def _mixed_requests():
    """(uid, prompt, sampling kwargs): prompts of 3-80 tokens (up to three
    32-token chunks), greedy and seeded top-k/top-p alternating."""
    rng = np.random.default_rng(0)
    out = []
    for i in range(6):
        prompt = rng.integers(1, 256, int(rng.integers(3, 81))).tolist()
        kw = dict(max_new_tokens=int(rng.integers(4, 12)), seed=10 + i)
        if i % 2:
            kw.update(temperature=0.8, top_k=20, top_p=0.9)
        out.append((f"r{i}", prompt, kw))
    return out


@pytest.fixture(scope="module")
def jax_streams(weights):
    """The JAX engine's streams: the mixed scenario on 3 slots, and the
    preemption tests' request (greedy and seeded) alone."""
    jcfg, jparams, _, _ = weights
    eng = JSSMEngine(jcfg, jparams, max_len=128, max_slots=3)
    mixed = eng.generate([JRequest(u, p, sampling=JSamplingParams(**kw))
                          for u, p, kw in _mixed_requests()])
    stats = {k: eng.stats[k] for k in ("prefill_chunks", "decode_steps")}
    eng = JSSMEngine(jcfg, jparams, max_len=64, max_slots=2)
    single = {
        name: eng.generate([JRequest("o", PREEMPT_PROMPT,
                                     sampling=JSamplingParams(**kw))])[0]
        for name, kw in (("greedy", dict(max_new_tokens=10)),
                         ("seeded", SAMPLED))}
    return ({r.uid: r.tokens for r in mixed}, stats,
            {k: r.tokens for k, r in single.items()})


def test_streams_match_jax_engine(weights, jax_streams):
    want, want_stats, _ = jax_streams
    eng = _engine(weights, max_len=128, max_slots=3)
    got = eng.generate([Request(u, p, sampling=SamplingParams(**kw))
                        for u, p, kw in _mixed_requests()])
    assert {r.uid: r.tokens for r in got} == want
    assert all(r.finish_reason == FinishReason.LENGTH for r in got)
    assert {k: eng.stats[k] for k in want_stats} == want_stats


# ---------------------------------------------------------------------------
# SlotStateBank lifecycle
# ---------------------------------------------------------------------------


def test_bank_snapshot_restore_roundtrip(weights):
    """snapshot() then restore() is exact (bit-level) and touches only the
    target slot; a parked snapshot is a copy that later writes to the slot
    do not reach."""
    cfg = weights[2]
    bank = SlotStateBank(cfg, max_slots=4, dtype=torch.float32, device="cpu")
    g = torch.Generator().manual_seed(0)
    for v in bank.state.values():
        v.copy_(torch.randn(v.shape, generator=g))
    before = {k: v.clone() for k, v in bank.state.items()}
    snap = bank.snapshot(2)
    for k, v in snap.items():
        assert torch.equal(v, before[k][:, 2])
    bank.zero(2)
    for k, v in snap.items():
        assert torch.equal(v, before[k][:, 2]), f"{k}: snapshot aliased"
    bank.restore(2, snap)
    for k, v in bank.state.items():
        assert torch.equal(v, before[k])


def test_slot_alloc_release_cycle(weights):
    """More requests than slots all finish, and every slot returns to the
    free list at drain."""
    eng = _engine(weights, max_len=64, max_slots=2)
    assert eng.capacity() == 2
    hs = [eng.submit(Request(f"r{i}", [1 + i, 2, 3], max_new_tokens=4))
          for i in range(5)]
    drain(eng)
    assert all(h.finish_reason == FinishReason.LENGTH for h in hs)
    assert sorted(eng._free) == [0, 1]
    assert eng.capacity() == 2 and not eng.slots and not eng._snapshots


def test_fresh_slot_never_leaks_previous_state(weights):
    """A recycled slot's prefill starts from zero state."""
    fresh = _engine(weights, max_len=64, max_slots=1)
    want = fresh.generate([Request("w", [5, 6, 7], max_new_tokens=6)])[0]
    eng = _engine(weights, max_len=64, max_slots=1)
    eng.generate([Request("dirty", [200, 201, 202, 203], max_new_tokens=8)])
    got = eng.generate([Request("w", [5, 6, 7], max_new_tokens=6)])[0]
    assert got.tokens == want.tokens


# ---------------------------------------------------------------------------
# preemption flavours: byte-identical streams
# ---------------------------------------------------------------------------


def _sampling(kind):
    return (SamplingParams(max_new_tokens=10) if kind == "greedy"
            else SamplingParams(**SAMPLED))


@pytest.mark.parametrize("sampling", ["greedy", "seeded"])
def test_discard_preemption_reprefills_byte_identical(weights, jax_streams,
                                                      sampling):
    eng = _engine(weights, max_len=64, max_slots=2)
    oracle = eng.generate([Request("o", PREEMPT_PROMPT,
                                   sampling=_sampling(sampling))])[0]
    h = eng.submit(Request("p", PREEMPT_PROMPT, sampling=_sampling(sampling)))
    while len(h.tokens) < 4:
        eng.step()
    seen = list(h.tokens)
    assert eng.preempt_youngest() == "p"
    drain(eng)
    assert eng.stats["preemptions"] == 1
    assert eng.stats["restores"] == 0  # discard flavour re-prefills
    assert h.tokens[:len(seen)] == seen  # no re-emission, no gap
    assert h.tokens == oracle.tokens == jax_streams[2][sampling]


@pytest.mark.parametrize("sampling", ["greedy", "seeded"])
def test_snapshot_preemption_resumes_byte_identical(weights, jax_streams,
                                                    sampling):
    """snapshot=True parks a host copy of the slot's state and the sequence
    resumes decoding without re-prefilling — same stream, zero extra
    prefill chunks after the eviction, even with another request taking
    the slot in between."""
    eng = _engine(weights, max_len=64, max_slots=1)
    h = eng.submit(Request("p", PREEMPT_PROMPT, sampling=_sampling(sampling)))
    while len(h.tokens) < 4:
        eng.step()
    assert eng.preempt_youngest(snapshot=True) == "p"
    assert "p" in eng._snapshots
    other = eng.submit(Request("q", [3, 1, 4, 1, 5], max_new_tokens=3))
    eng.admission.remove("p")  # let "q" take the slot first
    drain(eng)
    assert other.finish_reason == FinishReason.LENGTH
    chunks_before = eng.stats["prefill_chunks"]
    eng.admission.requeue(h.request, h.arrival)
    drain(eng)
    assert eng.stats["restores"] == 1
    assert eng.stats["prefill_chunks"] == chunks_before, "snapshot re-prefilled"
    assert not eng._snapshots, "parked snapshot leaked"
    assert h.tokens == jax_streams[2][sampling]


def test_preempt_youngest_picks_newest_decoder(weights):
    eng = _engine(weights, max_len=64, max_slots=3)
    old = eng.submit(Request("old", [1, 2, 3], max_new_tokens=30))
    while not old.tokens:
        eng.step()
    young = eng.submit(Request("young", [4, 5, 6], max_new_tokens=30))
    while not young.tokens:
        eng.step()
    assert eng.preempt_youngest() == "young"
    eng.abort_all()
    drain(eng)


def test_hybrid_engine_is_not_ported_yet(weights):
    """The hybrid engine is ported now: on zamba2 the SSM engine builds a
    ``num_layers // attn_every``-layer page pool beside its bank and
    serves a request (``tests/test_torch_hybrid_engine.py`` holds its
    streams against JAX's). Families without recurrent state are still
    refused, and the paged engine refuses both recurrent families, naming
    the engines that serve them."""
    from repro_torch.models import build_model
    from repro_torch.serving import ContinuousBatchingEngine

    cfg = reduced(ARCHS["zamba2-2.7b"])
    state = build_model(cfg, device="cpu").init(seed=0)
    eng = SSMEngine(cfg, state, max_len=32, max_slots=2, page_size=8,
                    device="cpu")
    assert eng.hybrid and eng.cache.pages["k"].shape[0] == (
        cfg.num_layers // cfg.attn_every)
    (res,) = eng.generate([Request("z", [3, 1, 4], max_new_tokens=3)])
    assert res.finish_reason == FinishReason.LENGTH and len(res.tokens) == 3
    assert eng.cache.pool.available == eng.cache.num_pages - 1
    with pytest.raises(AssertionError, match="recurrent-state"):
        SSMEngine(reduced(ARCHS["dbrx-132b"]), {}, device="cpu")
    for arch in ("zamba2-2.7b", "mamba2-1.3b"):
        with pytest.raises(NotImplementedError, match="SSMEngine"):
            ContinuousBatchingEngine(reduced(ARCHS[arch]), {}, device="cpu")


def test_serve_cli_mamba2(tmp_path):
    """``python -m repro_torch.launch.serve --arch mamba2-1.3b --reduced
    --device cpu`` serves every request through the SSM engine."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "mamba2-1.3b", "--reduced", "--device", "cpu", "--requests", "8",
         "--max-new", "4", "--workdir", str(tmp_path / "serve")],
        capture_output=True, text=True, env=env, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "served 8/8 requests" in out.stdout
    assert "engine=ssm" in out.stdout
