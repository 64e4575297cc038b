"""The port's speculative decoding against the JAX package's, on the CPU.

Reduced smollm-360m in float32, the JAX parameters carried across by
``params_from_jax``, inputs from numpy with fixed seeds:

* ``paged_verify_attention_ref`` equals the JAX oracle (1e-5; a full, a
  padded and the deepest bundle), and the port's verify contract holds as ``tests/test_kernel_fuzz.py`` states it
  for the JAX kernels: a k-draft bundle (k 1-8, padded bundles, COW-forked
  tables) scored through the chunk op equals the verify oracle, the mixed
  op with broadcast tables and a k+1-step decode loop (1e-3, the kernels'
  bound); padded rows are exact zeros; relocating a page changes nothing.
* ``DecoderLM.verify_step_paged``'s (C, Vp) logits and written pages equal
  the JAX model's within 1e-4 (the model tests' bound).
* ``NgramProposer`` drafts equal JAX's on seeded histories.
* ``ContinuousBatchingEngine(speculative="ngram"|"draft")`` streams equal
  the JAX engine's byte for byte, with the same ``spec_bundles`` and
  accepted/rolled-back counts, and equal the port's spec-off streams.
* The speculative stress arms of ``tests/test_serving_stress.py`` (ngram
  with the host and persisted tiers, an oracle draft on the target's
  weights, an adversarial random proposer), each over a pool that
  preempts, with the paged invariants and the publication rule checked
  after every step and streams equal to a spec-off replay.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JARCHS, reduced as jreduced  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.serving import ContinuousBatchingEngine as JEngine  # noqa: E402
from repro.serving import NgramProposer as JNgram  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import SamplingParams as JSamplingParams  # noqa: E402
from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import build_model, params_from_jax  # noqa: E402
from repro_torch.models.lm import padded_vocab  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    ContinuousBatchingEngine,
    NgramProposer,
    Request,
    SamplingParams,
    build_proposer,
)
from repro_torch.serving.kv_cache import NULL_PAGE, cdiv  # noqa: E402

TOL = 1e-3      # kernel contract (ops.py), as tests/test_kernel_fuzz.py
MODEL_TOL = 1e-4  # model entry points against the JAX model
PAGE = 8
MAX_LEN = 64


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# the verify oracle and the verify == chunk == mixed == decode loop contract
# ---------------------------------------------------------------------------
# params: (c, start, valid, h, kvh, d, page, extra), as the JAX sweep's:
#   c = bundle width W (spec_k + 1, padded), valid = 1 + k live rows,
#   start = the sequence's cached length L when the bundle dispatched


def _verify_sweep():
    cases = []
    rng = np.random.default_rng(0x5BEC)
    for k in range(1, 9):  # the engine's full draft-depth range
        start = int(rng.integers(1, 25))
        cases.append((k + 1, start, k + 1, 4, 2, 16, 8, 1))
        if k > 1:  # padded bundle: fewer drafts than the compiled width
            cases.append((k + 2, start, k + 1, 4, 2, 16, 8, 0))
    return cases


def _prefill_case(params, seed, forked=False):
    """Pool and block table of one chunk call (as the JAX sweep makes it):
    ``forked`` aliases a twin's pages, with a privately copied tail."""
    c, start, valid, h, kvh, d, page, extra = params
    rng = np.random.default_rng(seed)
    need = cdiv(max(start + valid, 1), page)
    num_pages = need * (2 if forked else 1) + 3
    q = rng.standard_normal((c, h, d)).astype(np.float32)
    kp = rng.standard_normal((num_pages, page, kvh, d)).astype(np.float32)
    vp = rng.standard_normal((num_pages, page, kvh, d)).astype(np.float32)
    perm = rng.permutation(np.arange(1, num_pages))
    bt = np.full((need + extra,), NULL_PAGE, np.int32)
    bt[:need] = perm[:need]
    if forked and need > 1:
        bt[need - 1] = perm[need]
    return q, kp, vp, bt, start, valid


def _close(got, want, what):
    err = float(np.abs(np.asarray(got, np.float32)
                       - np.asarray(want, np.float32)).max())
    assert err <= TOL, f"{what}: err={err:.3e} > {TOL}"


@pytest.mark.parametrize("params", [_verify_sweep()[i] for i in (0, 6, 14)],
                         ids=lambda p: "c{}s{}v{}h{}k{}d{}p{}x{}".format(*p))
def test_verify_ref_matches_jax(params):
    """The verify oracle against the JAX package's (one full bundle, one
    padded, the deepest), plain and forked tables."""
    for seed, forked in ((0, False), (1, True)):
        q, kp, vp, bt, start, valid = _prefill_case(params, seed, forked)
        jwant = jref.paged_verify_attention_ref(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(bt), jnp.int32(start), jnp.int32(valid))
        want = ref.paged_verify_attention_ref(
            _t(q), _t(kp), _t(vp), _t(bt), torch.tensor(start),
            torch.tensor(valid))
        np.testing.assert_allclose(want.numpy(), np.asarray(jwant),
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("params", _verify_sweep(),
                         ids=lambda p: "c{}s{}v{}h{}k{}d{}p{}x{}".format(*p))
def test_verify_equals_chunk_mixed_and_decode_loop(params):
    for seed, forked in ((0, False), (1, True)):
        q, kp, vp, bt, start, valid = _prefill_case(params, seed, forked)
        q_, kp_, vp_, bt_ = _t(q), _t(kp), _t(vp), _t(bt)
        st, va = torch.tensor(start), torch.tensor(valid)
        want = ref.paged_verify_attention_ref(q_, kp_, vp_, bt_, st, va)
        chunk = ops.paged_prefill_attention(q_, kp_, vp_, bt_, st, va)
        _close(chunk, want, f"verify_vs_chunk {params} {seed}")
        c = q.shape[0]
        idx = torch.arange(c)
        mixed = ops.paged_mixed_attention(
            q_, kp_, vp_, bt_.expand(c, bt_.shape[0]),
            torch.where(idx < valid, start + idx, -1).to(torch.int32))
        _close(mixed, want, f"verify_vs_mixed {params} {seed}")
        for j in range(valid):  # the decode loop the bundle replaces
            dec = ops.paged_attention(
                q_[j][None], kp_, vp_, bt_[None],
                torch.tensor([start + j + 1], dtype=torch.int32))[0]
            _close(dec, want[j], f"verify_vs_decode_loop {params} {seed} {j}")
        assert (want[valid:] == 0).all(), "padded verify rows must be 0"
        assert (chunk[valid:] == 0).all(), "padded chunk rows must be 0"


def test_verify_invariant_to_page_relocation():
    """Preempt-and-resume re-admits a sequence into other physical pages:
    moving a page and repointing the table changes no output."""
    params = (5, 11, 5, 4, 2, 16, 8, 1)
    q, kp, vp, bt, start, valid = _prefill_case(params, seed=9)
    st, va = torch.tensor(start), torch.tensor(valid)
    base = ref.paged_verify_attention_ref(_t(q), _t(kp), _t(vp), _t(bt),
                                          st, va)
    kp2, vp2, bt2 = kp.copy(), vp.copy(), bt.copy()
    live = [p for p in bt2.tolist() if p != NULL_PAGE]
    spare = next(p for p in range(1, kp2.shape[0]) if p not in live)
    kp2[spare], vp2[spare] = kp2[live[0]], vp2[live[0]]
    bt2[bt.tolist().index(live[0])] = spare
    moved = ops.paged_prefill_attention(_t(q), _t(kp2), _t(vp2), _t(bt2),
                                        st, va)
    _close(moved, base, "verify_page_relocation")


# ---------------------------------------------------------------------------
# the model entry point
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    jcfg = jreduced(JARCHS["smollm-360m"])
    jparams = jbuild(jcfg).init(jax.random.key(0))
    cfg = reduced(ARCHS["smollm-360m"])
    state = params_from_jax(cfg, jax.tree.map(np.asarray, jparams))
    return jcfg, jparams, cfg, state


@pytest.mark.parametrize("valid", [1, 4, 6])
def test_verify_step_paged_matches_jax(weights, valid):
    """A bundle of width 6 at start 13 (the bundle straddles a page) over
    random page contents: every row's logits and the pages it wrote equal
    the JAX model's; rows past ``valid`` write nothing the JAX pool sees
    (the port's go to its sink page)."""
    jcfg, jparams, cfg, state = weights
    jmodel = jbuild(jcfg)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(state)
    rng = np.random.default_rng(valid)
    n_pages = 10
    shape = (cfg.num_layers, n_pages, PAGE, cfg.num_kv_heads, cfg.head_dim)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    sink = np.zeros((cfg.num_layers, 1) + shape[2:], np.float32)
    tpages = {"k": _t(np.concatenate([k, sink], 1)),
              "v": _t(np.concatenate([v, sink], 1))}
    row = np.array([4, 9, 2, 0], np.int32)
    tokens = rng.integers(0, cfg.vocab_size, 6).astype(np.int32)
    jnew, jlogits = jax.jit(jmodel.verify_step_paged)(
        jparams, {"k": jnp.asarray(k), "v": jnp.asarray(v)},
        jnp.asarray(row), jnp.asarray(tokens), jnp.int32(13),
        jnp.int32(valid))
    logits = model.verify_step_paged(tpages, _t(row), _t(tokens),
                                     torch.tensor(13, dtype=torch.int32),
                                     torch.tensor(valid, dtype=torch.int32))
    assert logits.shape == (6, padded_vocab(cfg))
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=MODEL_TOL, rtol=MODEL_TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(tpages[key][:, :n_pages].numpy(),
                                   np.asarray(jnew[key]), atol=MODEL_TOL,
                                   rtol=MODEL_TOL)


def test_ngram_drafts_match_jax():
    rng = np.random.default_rng(7)
    for trial in range(40):
        motif = rng.integers(1, 20, int(rng.integers(1, 6))).tolist()
        history = (rng.integers(1, 20, int(rng.integers(0, 8))).tolist()
                   + motif * int(rng.integers(1, 4))
                   + rng.integers(1, 20, int(rng.integers(0, 4))).tolist())
        for n, k in ((1, 3), (3, 4), (4, 8)):
            want = JNgram(n=n).propose("u", list(history), k)
            got = NgramProposer(n=n).propose("u", list(history), k)
            assert got == want, (trial, history, n, k)


# ---------------------------------------------------------------------------
# the engine, stream for stream against the JAX engine and spec off
# ---------------------------------------------------------------------------

ENGINE_KW = dict(max_len=MAX_LEN, max_slots=3, page_size=PAGE,
                 prefill_chunk=8)


def _requests():
    """Prompts that end in a repeated motif (so the ngram proposer drafts)
    and prompts that do not; greedy and seeded top-k/top-p alternating."""
    rng = np.random.default_rng(3)
    out = []
    for i in range(6):
        motif = rng.integers(1, 256, int(rng.integers(2, 5))).tolist()
        head = rng.integers(1, 256, int(rng.integers(2, 12))).tolist()
        prompt = head + motif * 3 if i % 3 else head + motif
        kw = dict(max_new_tokens=int(rng.integers(6, 12)), seed=20 + i)
        if i % 2:
            kw.update(temperature=0.8, top_k=20, top_p=0.9)
        out.append((f"r{i}", prompt, kw))
    return out


def _serve(engine, req_cls, sp_cls):
    out = engine.generate([req_cls(u, p, sampling=sp_cls(**kw))
                           for u, p, kw in _requests()])
    u = engine.utilization
    return ([list(r.tokens) for r in out],
            (engine.stats["spec_bundles"], u.spec_proposed, u.spec_accepted,
             u.spec_rollbacks))


@pytest.fixture(scope="module")
def jax_streams(weights):
    """The JAX engine's streams and speculation counters, per mode."""
    jcfg, jparams, _, _ = weights
    out = {}
    for mode in ("off", "ngram", "draft"):
        kw = dict(speculative=mode, spec_k=3)
        if mode == "draft":
            kw.update(draft_config=jcfg, draft_params=jparams)
        out[mode] = _serve(JEngine(jcfg, jparams, **ENGINE_KW, **kw),
                           JRequest, JSamplingParams)
    return out


@pytest.mark.parametrize("mode", ["ngram", "draft"])
def test_engine_streams_match_jax_and_spec_off(weights, jax_streams, mode):
    _, _, cfg, state = weights
    kw = dict(speculative=mode, spec_k=3)
    if mode == "draft":  # an oracle draft: the target's own weights
        kw.update(draft_config=cfg, draft_params=state)
    eng = ContinuousBatchingEngine(cfg, state, device="cpu", **ENGINE_KW,
                                   **kw)
    got, counters = _serve(eng, Request, SamplingParams)
    want, jcounters = jax_streams[mode]
    assert got == want
    assert counters == jcounters
    assert counters[0] > 0, "no bundle dispatched"
    if mode == "draft":
        assert counters[2] > 0, "the oracle draft landed nothing"
    off = ContinuousBatchingEngine(cfg, state, device="cpu", **ENGINE_KW)
    assert _serve(off, Request, SamplingParams)[0] == got
    assert got == jax_streams["off"][0]


def test_engine_spec_arguments(weights):
    _, _, cfg, state = weights
    with pytest.raises(ValueError, match="speculative must be one of"):
        ContinuousBatchingEngine(cfg, state, device="cpu", speculative="on")
    with pytest.raises(ValueError, match="spec_k"):
        ContinuousBatchingEngine(cfg, state, device="cpu",
                                 speculative="ngram", spec_k=0)
    with pytest.raises(ValueError, match="fused"):
        ContinuousBatchingEngine(cfg, state, device="cpu",
                                 speculative="ngram", step_mode="interleaved")
    with pytest.raises(ValueError, match="draft_config"):
        ContinuousBatchingEngine(cfg, state, device="cpu",
                                 speculative="draft")
    # an arch name resolves through the port's configs, -reduced honored;
    # without draft_params the draft's weights come from the seed
    prop = build_proposer("draft", draft_config="smollm-360m-reduced",
                          max_slots=2, max_len=32, page_size=8, seed=5,
                          device="cpu")
    assert prop.cfg == reduced(ARCHS["smollm-360m"])
    again = build_proposer("draft", draft_config="smollm-360m-reduced",
                           max_slots=2, max_len=32, page_size=8, seed=5,
                           device="cpu")
    assert all(torch.equal(prop.params[k], again.params[k])
               for k in prop.params)
    assert prop.cache.device.type == "cpu"
    # requests may opt out: no bundle for a speculative=False request
    eng = ContinuousBatchingEngine(cfg, state, device="cpu",
                                   speculative="ngram", **ENGINE_KW)
    out = eng.generate([Request("o", [5, 6, 5, 6, 5, 6], sampling=SamplingParams(
        max_new_tokens=6, speculative=False))])[0]
    assert len(out.tokens) == 6 and eng.stats["spec_bundles"] == 0


# ---------------------------------------------------------------------------
# the speculative stress arms (tests/test_serving_stress.py)
# ---------------------------------------------------------------------------


def _make_trace(seed: int, n: int = 14):
    """The stress trace: explicit seeds, a shared 2-page prefix on half the
    requests, mixed greedy/sampled rows, submissions in bursts of three per
    step and two cancels mid-flight."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(1, 250, 2 * PAGE).tolist()
    reqs = []
    for i in range(n):
        body = rng.integers(1, 250, int(rng.integers(3, 15))).tolist()
        sampled = i % 5 == 4
        reqs.append(Request(
            f"s{i}", (prefix if i % 2 == 0 else []) + body,
            sampling=SamplingParams(
                temperature=0.7 if sampled else 0.0,
                top_k=8 if sampled else 0,
                max_new_tokens=int(rng.integers(3, 7)), seed=1000 + i)))
    actions: dict[int, list[tuple[str, str]]] = {}
    for i, r in enumerate(reqs):
        actions.setdefault(i // 3, []).append(("submit", r.uid))
    actions.setdefault(4, []).append(("cancel", reqs[2].uid))
    actions.setdefault(2, []).append(("cancel", reqs[5].uid))
    return reqs, actions


def _check_spec_invariants(engine) -> None:
    """The paged sweep of the stress file (refcounts equal live table
    references; free, referenced and parked pages partition the pool;
    parked pages keep their index entry; the prefix index maps only full
    frozen pages, bijectively; occupancy equals the live sequences) plus
    the publication rule: a page past the prompt, where bundles write K/V
    that may be rejected, is never in the prefix index, so never parked."""
    cache, sched, pool = engine.cache, engine.scheduler, engine.cache.pool
    refs: dict[int, int] = {}
    for slot in range(cache.max_slots):
        for p in cache._slot_pages[slot]:
            assert p != NULL_PAGE
            refs[p] = refs.get(p, 0) + 1
    for page in range(1, cache.num_pages):
        assert int(pool.refcounts[page]) == refs.get(page, 0), page
    free, used = pool._free, set(refs)
    assert len(set(free)) == len(free), "double-freed page"
    tiers = cache.tiers
    parked = set(tiers.parked) if tiers is not None else set()
    assert not set(free) & used and not parked & used and not set(free) & parked
    assert set(free) | used | parked == set(range(1, cache.num_pages)), \
        "leaked page"
    for p in parked:
        assert int(pool.refcounts[p]) == 0 and p in cache._page_key, p
    assert len(cache._page_key) == len(cache._prefix_index)
    for key, page in cache._prefix_index.items():
        assert len(key[1]) == cache.page_size, "partial page in the index"
        assert cache._page_key.get(page) == key
    live = set(sched.slots)
    assert live == {s for s in range(cache.max_slots)
                    if cache._slot_pages[s]}
    assert set(cache._free_slots) == set(range(cache.max_slots)) - live
    for slot, seq in sched.slots.items():
        prompt_pages = len(seq.request.prompt) // cache.page_size
        for i, p in enumerate(cache._slot_pages[slot]):
            if i >= prompt_pages:
                assert p not in cache._page_key, (
                    f"slot {slot}: decode-phase page {p} (index {i}) was "
                    f"published to the prefix index")


def _drive(engine, reqs, actions):
    """Run the schedule through ``step()``, checking the invariants and
    the events' order after every step."""
    by_uid = {r.uid: r for r in reqs}
    handles, cancelled, last = {}, set(), {}
    step = 0
    while True:
        for kind, uid in actions.get(step, []):
            if kind == "submit":
                handles[uid] = engine.submit(by_uid[uid])
            elif engine.cancel(uid):
                cancelled.add(uid)
        for ev in engine.step():
            if ev.kind == "token":
                assert ev.index == last.get(ev.uid, -1) + 1
                last[ev.uid] = ev.index
                assert handles[ev.uid].tokens[ev.index] == ev.token
        _check_spec_invariants(engine)
        step += 1
        if all(s <= step for s in actions) and engine.idle:
            return handles, cancelled
        assert step < 600, "trace failed to drain"


class _AdversarialProposer:
    """k uniformly random drafts for every slot, every step: bundles always
    dispatch and essentially every draft is rejected."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)

    def propose(self, uid, history, k):
        return [int(t) for t in self.rng.integers(1, 250, k)]

    def retire(self, uid):
        return None


@pytest.fixture(scope="module")
def smollm():
    cfg = reduced(ARCHS["smollm-360m"])
    return cfg, build_model(cfg, device="cpu").init(seed=0)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("mode", ["ngram", "draft", "adversarial"])
def test_speculative_stress_arm(smollm, seed, mode, tmp_path):
    cfg, params = smollm
    reqs, actions = _make_trace(seed)
    kw = dict(max_slots=4, page_size=PAGE, num_pages=8, prefill_chunk=PAGE,
              prefix_sharing=True, seed=seed)
    spec_kw = dict(speculative="ngram", spec_k=3)
    if mode == "draft":
        spec_kw = dict(speculative="draft", spec_k=3, draft_config=cfg,
                       draft_params=params)
    else:
        kw.update(host_pages=16, persist_dir=str(tmp_path / "kv"))
    engine = ContinuousBatchingEngine(cfg, params, max_len=MAX_LEN,
                                      device="cpu", **kw, **spec_kw)
    if mode == "adversarial":
        engine.spec = _AdversarialProposer(seed)
    handles, cancelled = _drive(engine, reqs, actions)
    u = engine.utilization
    if mode == "adversarial":
        assert engine.stats["spec_bundles"] > 0, "no bundle ever dispatched"
        assert u.spec_rollbacks > 0, "rollback path unexercised"
    elif mode == "draft":
        assert engine.stats["spec_bundles"] > 0, "no bundle ever dispatched"
        assert u.spec_accepted > 0, "commit path unexercised"
    cache = engine.cache  # drained: every page free or parked
    assert cache.pool.available + cache.parked_count == cache.num_pages - 1
    assert (cache.pool.refcounts[1:] == 0).all()
    # spec-off, unperturbed replay (no cancels, ample pages)
    oracle = ContinuousBatchingEngine(
        cfg, params, max_len=MAX_LEN, device="cpu", max_slots=4,
        page_size=PAGE, prefill_chunk=PAGE, prefix_sharing=True, seed=seed)
    want = {r.uid: r.tokens for r in oracle.generate(reqs)}
    for uid, h in handles.items():
        if uid in cancelled:
            assert h.tokens == want[uid][:len(h.tokens)], uid
        else:
            assert h.tokens == want[uid], uid
