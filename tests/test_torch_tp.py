"""Tensor-parallel serving in the port (``repro_torch.parallel``, the sharded
executors), on the CPU: CPU ranks over gloo.

One module-scoped mesh of two CPU ranks (this process and one spawned
follower) serves every two-rank case; a second one is spawned only to be
killed. Reduced configs in f32:

* the collectives (``psum_tp``, ``pmean_tp``, ``all_gather_logits``)
  against numpy sums and concatenation, and the identity outside a
  ``tensor_parallel`` context; ports of ``tests/test_collectives.py``'s four
  tests on one rank and on two;
* ports of ``tests/test_serving_sharded.py``'s executor tests: ``pick_tp``,
  the indivisible mesh refused, the layout (local kv heads on every pool
  array of every rank, local heads on ``wq``, the embedding whole);
* token streams at tp 2 equal the JAX package's 1-device
  ``ContinuousBatchingEngine`` / ``SSMEngine`` (run in a subprocess with
  ``XLA_FLAGS=--xla_force_host_platform_device_count=2``, which also runs
  JAX's own 2-device sharded engine on the smollm trace), greedy and
  seeded top-p: smollm (tied) in both step modes, on the reference's
  ``_trace`` and under prefix sharing with a preemption; int8 pages;
  llama3 (untied: the logits gather) whole-prompt; ngram speculation;
  mamba2 (with a snapshot preemption) and zamba2 through ``SSMEngine``;
* every entry point's logits at tp 2 within 1e-5 of tp 1 for the dense,
  moe, ssm, hybrid and vlm families; the copy-on-write page copy replayed on
  the follower;
* the serve driver's ``--mesh``; no child outlives ``close``; a dead
  follower fails the next call with its rank; the ROADMAP A.10b
  combinations (KV tiers, the draft proposer) serving at tp 2.
"""

import json
import multiprocessing
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh, make_serving_mesh  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.parallel import (all_gather_logits, pmean_tp,  # noqa: E402
                                  psum_tp, tensor_parallel)
from repro_torch.parallel.collectives import (  # noqa: E402
    compressed_psum, dequantize_int8, flatten_grads,
    make_compressed_grad_allreduce, quantize_int8, unflatten_grads)
from repro_torch.serving import (ContinuousBatchingEngine, Request,  # noqa: E402
                                 SamplingParams, SSMEngine)
from repro_torch.serving.executor import (pick_tp,  # noqa: E402
                                          place_serving_params,
                                          serving_mesh_scope)

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-5
# the JAX init seed of each config (tests/test_serving_sharded.py's)
SEEDS = {"smollm-360m": 0, "llama3-8b": 1, "mamba2-1.3b": 0,
         "zamba2-2.7b": 0, "dbrx-132b": 0}


@pytest.fixture(scope="module")
def mesh2(tmp_path_factory):
    mesh = make_serving_mesh(2, devices=["cpu", "cpu"],
                             init_dir=str(tmp_path_factory.mktemp("tp")))
    mesh.group  # spawn the follower once for the module
    yield mesh
    mesh.close()


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def test_collectives_match_numpy_on_two_ranks(mesh2):
    rng = np.random.default_rng(0)
    xs = [rng.standard_normal((3, 8)).astype(np.float32) for _ in range(2)]
    args = [(torch.from_numpy(x),) for x in xs]
    g = mesh2.group
    for got in g.spmd(psum_tp, args):
        np.testing.assert_allclose(got.numpy(), xs[0] + xs[1], rtol=1e-6)
    for got in g.spmd(pmean_tp, args):
        np.testing.assert_allclose(got.numpy(), (xs[0] + xs[1]) / 2,
                                   rtol=1e-6)
    # bf16 partials are summed in f32 and rounded once
    b16 = [(torch.from_numpy(x).to(torch.bfloat16),) for x in xs]
    want = (b16[0][0].float() + b16[1][0].float()).to(torch.bfloat16)
    for got in g.spmd(psum_tp, b16):
        assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    # the vocab-sharded logits gather: the ranks' column slices in order
    for got in g.spmd(all_gather_logits, args, vocab_sharded=True):
        np.testing.assert_array_equal(got.numpy(), np.concatenate(xs, -1))
    # replicated (tied) logits are never gathered: that would tile them
    for got, x in zip(g.spmd(all_gather_logits, args), xs):
        np.testing.assert_array_equal(got.numpy(), x)


def test_collectives_are_identity_outside_a_context():
    x = torch.arange(6.0).reshape(2, 3)
    assert psum_tp(x) is x and pmean_tp(x) is x
    assert all_gather_logits(x) is x
    with tensor_parallel(None, vocab_sharded=True):  # a one-rank mesh
        assert psum_tp(x) is x and all_gather_logits(x) is x


def _run(mesh, ranks, fn, args_by_rank):
    """``fn`` on one rank (this process) or on both ranks of ``mesh``."""
    if ranks == 1:
        return [fn(*args_by_rank[0])]
    return mesh.group.spmd(fn, args_by_rank)


@pytest.mark.parametrize("ranks", [1, 2])
def test_quantize_roundtrip_error_bounded(mesh2, ranks):
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(1024)
                         .astype(np.float32))
    for q, scale in _run(mesh2, ranks, quantize_int8, [(x,)] * ranks):
        err = (dequantize_int8(q, scale) - x).abs()
        assert err.max() <= float(scale) * 0.5 + 1e-7  # half-ULP rounding


@pytest.mark.parametrize("ranks", [1, 2])
def test_flatten_unflatten_roundtrip(mesh2, ranks):
    rng = np.random.default_rng(0)
    tree = {"a": torch.from_numpy(rng.standard_normal((3, 4))
                                  .astype(np.float32)),
            "b": {"c": torch.from_numpy(rng.standard_normal(7)
                                        .astype(np.float32))}}
    for flat, meta in _run(mesh2, ranks, flatten_grads, [(tree,)] * ranks):
        back = unflatten_grads(flat, meta)
        assert torch.equal(back["a"], tree["a"])
        assert torch.equal(back["b"]["c"], tree["b"]["c"])


@pytest.mark.parametrize("ranks", [1, 2])
def test_error_feedback_unbiased_over_steps(mesh2, ranks):
    """Repeatedly reducing the SAME gradients with error feedback must
    converge: the cumulative mean of compressed reductions approaches the
    exact mean (the EF carry re-injects quantization residuals). On one
    rank the host mesh's one shard; on two, each rank's own row."""
    mesh = make_host_mesh() if ranks == 1 else mesh2
    n = 1 if ranks == 1 else 2
    ef = make_compressed_grad_allreduce(mesh, "data" if ranks == 1
                                        else "model")
    g = torch.from_numpy(np.random.default_rng(0).standard_normal((n, 512))
                         .astype(np.float32))
    exact = g.mean(0)
    carries = [torch.zeros((1, 512)) for _ in range(n)]
    acc = torch.zeros(512)
    steps = 20
    for _ in range(steps):
        outs = _run(mesh2, ranks, ef, [(g[r:r + 1], carries[r])
                                       for r in range(n)])
        for a, b in zip(outs, outs[1:]):
            assert torch.equal(a[0], b[0])  # every rank: the same mean
        carries = [c for _, c in outs]
        acc += outs[0][0]
    avg = acc / steps
    one_shot = _run(mesh2, ranks, ef, [(g[r:r + 1], torch.zeros((1, 512)))
                                       for r in range(n)])[0][0]
    # single-shot error can be ~1e-2; EF-averaged error is ~n x smaller
    assert (avg - exact).abs().max() <= (one_shot - exact).abs().max() + 1e-6
    assert (avg - exact).abs().max() < 5e-3


@pytest.mark.parametrize("ranks", [1, 2])
def test_compressed_psum_close_to_exact(mesh2, ranks):
    rng = np.random.default_rng(0)
    xs = [torch.from_numpy(rng.standard_normal(256).astype(np.float32))
          for _ in range(ranks)]
    axis = None if ranks == 1 else mesh2
    outs = _run(mesh2, ranks, compressed_psum, [(x, axis) for x in xs])
    exact = sum(xs)
    scale = max(float(x.abs().max()) for x in xs) / 127.0
    for out in outs:
        # each shard's requantization is off by at most half a step
        assert (out - exact).abs().max() <= ranks * scale / 2 + 1e-6


# ---------------------------------------------------------------------------
# mesh selection + the sharding contract (tests/test_serving_sharded.py)
# ---------------------------------------------------------------------------


def test_pick_tp_respects_divisibility():
    cfg = reduced(ARCHS["smollm-360m"])      # kv=2, heads=4, ff=128, tied
    assert pick_tp(cfg, 1) == 1
    assert pick_tp(cfg, 2) == 2
    assert pick_tp(cfg, 4) == 2              # kv_heads=2 caps the degree
    assert pick_tp(cfg, 3) == 2
    untied = reduced(ARCHS["llama3-8b"])     # untied: padded vocab counts
    assert pick_tp(untied, 2) == 2
    # --mesh auto on the CPU (or one card) is tp 1
    assert pick_tp(cfg) == max(1, min(2, torch.cuda.device_count()))


@pytest.fixture(scope="module")
def smollm():
    cfg = reduced(ARCHS["smollm-360m"])
    return cfg, _jax_params(cfg)


def test_mesh_size_that_does_not_divide_heads_is_rejected(smollm):
    cfg, params = smollm
    mesh = make_serving_mesh(3, devices=["cpu"] * 3)
    with serving_mesh_scope(mesh):  # kv_heads=2 % 3 != 0
        with pytest.raises(ValueError, match="does not divide"):
            ContinuousBatchingEngine(cfg, params, max_len=64, max_slots=2,
                                     page_size=8, device="cpu")
    assert not mesh.started  # refused before spawning anything


def test_pages_and_params_sharded_over_model_axis(smollm, mesh2):
    """Every rank's pool holds its kv heads (every pool array, int8 scales
    too) and the same pages; ``wq`` its q heads; the embedding whole."""
    cfg, params = smollm
    with serving_mesh_scope(mesh2):
        eng = ContinuousBatchingEngine(cfg, params, max_len=64, max_slots=3,
                                       page_size=8, kv_quant="int8",
                                       device="cpu")
    ex = eng.executor
    assert ex.tp == 2 and ex.mesh.axis_names == ("model",)
    infos = ex.on_every_rank("rank_info")
    eng.close()
    assert infos[1] == ex.follower_info[1]
    kvh, h = cfg.eff_kv_heads // 2, cfg.eff_heads // 2
    for info in infos:
        assert set(info["pages"]) == {"k", "v", "k_scale", "v_scale"}
        for arr in info["pages"].values():
            assert arr[3] == kvh                          # heads sharded
            assert arr[1] == eng.cache.num_pages + 1      # pages NOT
        assert info["params"]["layers.attn.wq"][2] == h
        assert info["params"]["embed"] == tuple(params["embed"].shape)


# ---------------------------------------------------------------------------
# streams against the JAX engines
# ---------------------------------------------------------------------------


def _jax_params(cfg):
    """The JAX init of ``cfg``'s reduced config (the seed of SEEDS), as the
    port's state dict."""
    import jax

    from repro.configs import ARCHS as JARCHS, reduced as jreduced
    from repro.models import build_model as jbuild
    from repro_torch.models import params_from_jax

    arch = cfg.name.removesuffix("-reduced")
    jparams = jbuild(jreduced(JARCHS[arch])).init(
        jax.random.key(SEEDS[arch]))
    return params_from_jax(cfg, jax.tree.map(np.asarray, jparams))


def _trace(vocab, n=5):
    """tests/test_serving_sharded.py's ``_trace``: (uid, prompt, sampling)."""
    rng = np.random.default_rng(3)
    reqs = [(f"t{i}", [int(t) for t in rng.integers(1, vocab,
                                                    rng.integers(3, 40))],
             dict(max_new_tokens=int(rng.integers(2, 9))))
            for i in range(n)]
    reqs.append(("hot", [5, 6, 7], dict(temperature=1.0, top_k=20, top_p=0.9,
                                        seed=13, max_new_tokens=6)))
    return reqs


def _pressure(vocab):
    """A shared 24-token prefix (three pages) and a pool that must preempt;
    greedy and seeded top-p alternating."""
    rng = np.random.default_rng(7)
    shared = [int(t) for t in rng.integers(1, vocab, 24)]
    out = []
    for i in range(6):
        tail = [int(t) for t in rng.integers(1, vocab, rng.integers(3, 12))]
        kw = dict(max_new_tokens=10, seed=20 + i)
        if i % 2:
            kw.update(temperature=0.8, top_k=20, top_p=0.9)
        out.append((f"p{i}", shared + tail, kw))
    return out


def _ssm_trace(vocab):
    """``_trace``'s shape for the SSM engines, its prompt lengths cut to
    two final-chunk lengths (JAX's SSM engine compiles its chunk step once
    per final-chunk length, ~2 s each)."""
    rng = np.random.default_rng(3)
    reqs = [(f"s{i}", [int(t) for t in rng.integers(1, vocab, n)],
             dict(max_new_tokens=int(rng.integers(2, 9))))
            for i, n in enumerate([5, 21, 37, 21, 5])]
    reqs.append(("hot", [5, 6, 7, 8, 9], dict(
        temperature=1.0, top_k=20, top_p=0.9, seed=13, max_new_tokens=6)))
    return reqs


PAGED = dict(max_len=64, max_slots=3, page_size=8)
# name -> (arch, engine, engine kwargs, trace)
SCENARIOS = {
    "trace": ("smollm-360m", "paged", PAGED, _trace(256)),
    "pressure": ("smollm-360m", "paged",
                 dict(PAGED, num_pages=11, prefill_chunk=8), _pressure(256)),
    "int8": ("smollm-360m", "paged", dict(PAGED, kv_quant="int8"),
             _trace(256)),
    "untied-whole": ("llama3-8b", "paged",
                     dict(max_len=64, max_slots=2, page_size=8,
                          prefill_chunk=None),
                     [("u0", [1, 2, 3, 4], dict(max_new_tokens=6)),
                      ("u1", [9, 8, 7], dict(max_new_tokens=4))]),
    "mamba2": ("mamba2-1.3b", "ssm", dict(max_len=64, max_slots=3,
                                          prefill_chunk=16), _ssm_trace(256)),
    "zamba2": ("zamba2-2.7b", "ssm", dict(max_len=64, max_slots=3,
                                          prefill_chunk=16, page_size=8),
               _ssm_trace(256)),
}

# runs in a subprocess: JAX with two forced host devices
_JAX_SCRIPT = r"""
import json, sys
import jax
from repro.configs import ARCHS, reduced
from repro.launch.mesh import make_serving_mesh
from repro.models import build_model
from repro.serving import (ContinuousBatchingEngine, Request, SamplingParams,
                           SSMEngine)
from repro.serving.executor import serving_mesh_scope

job = json.load(sys.stdin)
out = {}
for name, (arch, kind, kw, reqs, devices) in job["runs"].items():
    cfg = reduced(ARCHS[arch])
    params = build_model(cfg).init(jax.random.key(job["seeds"][arch]))
    cls = SSMEngine if kind == "ssm" else ContinuousBatchingEngine
    with serving_mesh_scope(make_serving_mesh(devices)):
        eng = cls(cfg, params, **kw)
    tp = eng.executor.tp
    hs = [eng.submit(Request(u, p, sampling=SamplingParams(**s)))
          for u, p, s in reqs]
    while not eng.idle:
        eng.step()
    out[name] = {"tp": tp, "streams": [list(map(int, h.tokens)) for h in hs]}
print(json.dumps(out))
"""


@pytest.fixture(scope="module", autouse=True)
def jax_streams():
    """Every scenario through JAX's 1-device engine, and the trace through
    JAX's own 2-device sharded engine: two subprocesses (the paged
    scenarios, the SSM ones; ~45 and ~35 s of JAX compiles) started before
    the module's first test, so the port's runs overlap them."""
    runs = {name: (arch, kind, kw, reqs, 1)
            for name, (arch, kind, kw, reqs) in SCENARIOS.items()}
    runs["trace-sharded"] = runs["trace"][:4] + (2,)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               PYTHONPATH=str(REPO / "src"))
    procs = []
    for ssm in (False, True):
        part = {k: v for k, v in runs.items() if (v[1] == "ssm") == ssm}
        with tempfile.TemporaryFile("w+") as job:
            json.dump({"runs": part, "seeds": SEEDS}, job)
            job.seek(0)
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _JAX_SCRIPT], env=env, stdin=job,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    done = {}

    def get():
        for proc in procs if not done else ():
            out, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err[-3000:]
            done.update(json.loads(out.strip().splitlines()[-1]))
        return done

    yield get
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _serve(eng, reqs, preempt_at=None):
    hs = [eng.submit(Request(u, p, sampling=SamplingParams(**s)))
          for u, p, s in reqs]
    steps = 0
    while not eng.idle:
        eng.step()
        steps += 1
        if steps == preempt_at:
            assert eng.preempt_youngest(snapshot=True) is not None
    return [list(h.tokens) for h in hs]


_PARAMS: dict = {}


def _params(arch):
    if arch not in _PARAMS:
        _PARAMS[arch] = _jax_params(reduced(ARCHS[arch]))
    return _PARAMS[arch]


# ---------------------------------------------------------------------------
# per entry point: tp 2 against tp 1
# ---------------------------------------------------------------------------


def _heads_slice(a: np.ndarray, axis: int, rank: int, tp: int) -> torch.Tensor:
    n = a.shape[axis] // tp
    return torch.from_numpy(np.ascontiguousarray(
        np.take(a, range(rank * n, (rank + 1) * n), axis=axis)))


def _entry_logits(arch, params, rank, tp):
    """Every serving and dense-cache entry point of ``arch``'s reduced
    model on this rank's weights (the whole at tp 1): {entry: logits}.
    Pools, banks and inputs come from fixed seeds, cut to this rank's
    heads."""
    cfg = reduced(ARCHS[arch])
    model = build_model(cfg, params=params, device="cpu")
    rng = np.random.default_rng(5)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32)  # noqa: E731
    out = {}
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (2, 12))
                            .astype(np.int32))
    batch = {"tokens": toks}
    if cfg.family == "vlm":  # non-zero vision embeddings ahead of the text
        batch["vision_embeds"] = torch.from_numpy(rng.standard_normal(
            (2, cfg.num_frontend_tokens, cfg.d_model)).astype(np.float32))
    cache, out["prefill"] = model.prefill(
        batch, 16 + cfg.num_frontend_tokens)
    cache, out["decode_step"] = model.decode_step(cache, toks[:, -1:])
    kvl = (cfg.num_layers if cfg.family in ("dense", "moe")
           else cfg.num_layers // max(cfg.attn_every, 1))
    pool = (rng.standard_normal((kvl, 13, 8, cfg.eff_kv_heads, cfg.head_dim))
            .astype(np.float32))
    pages = lambda: {k: _heads_slice(pool * (1 + (k == "v")), 3, rank, tp)  # noqa: E731
                     for k in ("k", "v")}
    bt = np.array([[3, 7, 1, 0], [0, 0, 0, 0], [9, 2, 0, 0]], np.int32)
    lengths = np.array([17, 0, 8], np.int32)
    row = torch.from_numpy(np.array([5, 2, 9, 0], np.int32))
    chunk = torch.from_numpy(rng.integers(1, cfg.vocab_size, 8)
                             .astype(np.int32))
    tok3 = torch.from_numpy(rng.integers(1, cfg.vocab_size, (3, 1))
                            .astype(np.int32))
    if cfg.family in ("dense", "moe", "vlm"):
        out["decode_step_paged"] = model.decode_step_paged(
            pages(), torch.from_numpy(bt), torch.from_numpy(lengths), tok3)
        out["prefill_chunk"] = model.prefill_chunk(pages(), row, chunk,
                                                   i32(11), i32(5))
        out["verify_step_paged"] = model.verify_step_paged(
            pages(), row, chunk, i32(11), i32(5))
        tables = np.concatenate([bt, np.repeat(row.numpy()[None], 8, 0)])
        positions = np.array([12, -1, 24] + [9 + i if i < 5 else -1
                                             for i in range(8)], np.int32)
        out["mixed_step_paged"] = model.mixed_step_paged(
            pages(), torch.from_numpy(tables), torch.from_numpy(positions),
            torch.cat([tok3, chunk[:, None]]), num_decode=3,
            chunk_valid=i32(5))
        return {k: v.numpy() for k, v in out.items()}
    bank_full = {
        "ssm": rng.standard_normal((cfg.num_layers, 3, cfg.ssm_heads,
                                    cfg.ssm_head_dim, cfg.ssm_state)),
        "conv_x": rng.standard_normal((cfg.num_layers, 3,
                                       cfg.conv_width - 1, cfg.d_inner)),
        "conv_b": rng.standard_normal((cfg.num_layers, 3,
                                       cfg.conv_width - 1, cfg.ssm_state)),
        "conv_c": rng.standard_normal((cfg.num_layers, 3,
                                       cfg.conv_width - 1, cfg.ssm_state)),
    }
    axis = {"ssm": 2, "conv_x": 3}

    def bank():
        return {k: (_heads_slice(v.astype(np.float32), axis[k], rank, tp)
                    if k in axis else torch.from_numpy(v.astype(np.float32)))
                for k, v in bank_full.items()}

    active = torch.from_numpy(np.array([1, 0, 1], np.int32))
    if cfg.family == "ssm":
        out["decode_step_ssm"] = model.decode_step_ssm(bank(), tok3, active)
        _, out["prefill_chunk_ssm"] = model.prefill_chunk_ssm(
            {k: v[:, :1] for k, v in bank().items()}, chunk, 5)
    else:
        out["decode_step_hybrid"] = model.decode_step_hybrid(
            pages(), bank(), torch.from_numpy(bt), torch.from_numpy(lengths),
            tok3, active)
        _, out["prefill_chunk_hybrid"] = model.prefill_chunk_hybrid(
            pages(), {k: v[:, :1] for k, v in bank().items()}, row, chunk,
            11, 5)
    return {k: v.numpy() for k, v in out.items()}


@pytest.mark.parametrize("arch", ["smollm-360m", "dbrx-132b", "mamba2-1.3b",
                                  "zamba2-2.7b", "internvl2-26b"],
                         ids=["dense", "moe", "ssm", "hybrid", "vlm"])
def test_entry_point_logits_at_tp2_match_tp1(mesh2, arch):
    cfg = reduced(ARCHS[arch])
    params = build_model(cfg, device="cpu").init(seed=3)
    want = _entry_logits(arch, params, 0, 1)
    placed = place_serving_params(cfg, params, mesh2)
    got = mesh2.group.spmd(_entry_logits,
                           [(arch, placed[r], r, 2) for r in range(2)],
                           vocab_sharded=not cfg.tie_embeddings)
    for rank_out in got:
        assert rank_out.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(rank_out[k], want[k], atol=TOL,
                                       rtol=TOL, err_msg=f"{arch} {k}")


def test_copy_on_write_replays_on_every_rank(smollm, mesh2):
    """A fork's first append copies the shared partial page on rank 0
    (``ensure_append_capacity``); the follower copies its own heads of it
    before its next step: on every rank the copy equals the source's rows
    up to the fork."""
    cfg, params = smollm
    with serving_mesh_scope(mesh2):
        eng = ContinuousBatchingEngine(cfg, params, max_len=64, max_slots=3,
                                       page_size=8, prefill_chunk=8,
                                       device="cpu")
    h = eng.submit(Request("a", list(range(3, 15)),
                           sampling=SamplingParams(max_new_tokens=8)))
    while not h.tokens:
        eng.step()
    cache = eng.cache
    slot = eng.scheduler.find("a")
    n = int(cache.lengths[slot]) % cache.page_size
    fork = cache.fork(slot)
    cache.ensure_append_capacity(fork)
    assert cache.stats["cow_copies"] == 1
    old, new = cache._slot_pages[slot][-1], cache._slot_pages[fork][-1]
    cache.release(fork)
    eng.step()  # carries the copy to the follower
    ranks = eng.executor.on_every_rank("page_contents", [old, new])
    eng.close()
    for r, pages in enumerate(ranks):
        for k, v in pages.items():
            assert v[:, 0, :n].abs().sum() > 0, (r, k)
            assert torch.equal(v[:, 1, :n], v[:, 0, :n]), (r, k)


# ---------------------------------------------------------------------------
# the driver, the processes, the refusals
# ---------------------------------------------------------------------------


def _serve_cli(tmp_path, *argv):
    import contextlib
    import io

    from repro_torch.launch import serve

    out, saved = io.StringIO(), sys.argv
    sys.argv = ["serve", "--reduced", "--device", "cpu", "--requests", "6",
                "--max-new", "4", "--workdir", str(tmp_path / "w"), *argv]
    try:
        with contextlib.redirect_stdout(out):
            assert serve.main() == 0
    finally:
        sys.argv = saved
    return out.getvalue()


def test_serve_driver_mesh(tmp_path):
    """``--mesh auto`` on the CPU is tp 1 and spawns nothing; ``--mesh 2``
    serves on two CPU ranks and ends them."""
    before = set(multiprocessing.active_children())
    out = _serve_cli(tmp_path, "--mesh", "auto")
    assert "served 6/6" in out and "mesh=model=1" in out
    assert "tensor-parallel group" not in out
    out = _serve_cli(tmp_path, "--mesh", "2", "--arch", "mamba2-1.3b")
    assert "served 6/6" in out and "engine=ssm" in out
    assert "mesh=model=2" in out and "backend gloo" in out
    assert set(multiprocessing.active_children()) == before


def test_no_child_outlives_close_and_a_dead_follower_names_its_rank(smollm,
                                                                    tmp_path):
    """An engine on its own mesh: killing the follower fails the next call
    with the rank and exit code; closing ends every child."""
    cfg, params = smollm
    before = set(multiprocessing.active_children())
    mesh = make_serving_mesh(2, devices=["cpu", "cpu"], init_dir=str(tmp_path))
    with serving_mesh_scope(mesh):
        eng = ContinuousBatchingEngine(cfg, params, max_len=64, max_slots=2,
                                       page_size=8, device="cpu")
    eng.generate([Request("x", [1, 2, 3], max_new_tokens=3)])
    (proc,) = mesh.group.procs
    proc.kill()
    proc.join()
    eng.submit(Request("y", [4, 5, 6], max_new_tokens=3))
    with pytest.raises(RuntimeError, match="rank 1 .* exited with code -9"):
        while not eng.idle:
            eng.step()
    mesh.close()
    assert set(multiprocessing.active_children()) == before
    assert not any(Path(tmp_path).iterdir())  # rendezvous files removed


def test_a10b_combinations_serve(smollm, mesh2, tmp_path):
    """At tp > 1 (ROADMAP A.10b, once refused): the host and persisted KV
    tiers and the draft-model proposer (an oracle draft: the target's own
    weights) serve the trace with tp 2's plain streams; the tiers keep
    whole pages (every rank's heads) and the draft accepts. The combos
    against JAX's 2-device engine, and the fleet, are in
    ``test_torch_tp_combos.py``."""
    cfg, params = smollm
    kw = dict(max_len=64, max_slots=2, page_size=8, device="cpu")
    reqs = _trace(256, n=3)
    with serving_mesh_scope(mesh2):
        plain = ContinuousBatchingEngine(cfg, params, **kw)
        want = _serve(plain, reqs)
        plain.close()
        for extra in (dict(host_pages=4, num_pages=9),
                      dict(persist_dir=str(tmp_path / "kv")),
                      dict(speculative="draft", draft_config=cfg,
                           draft_params=params)):
            eng = ContinuousBatchingEngine(cfg, params, **kw, **extra)
            try:
                assert eng.executor.tp == 2
                assert _serve(eng, reqs) == want, extra
                if eng.spec is not None:
                    assert eng.utilization.spec_accepted > 0
                else:
                    eng.cache.flush_tiers()
                    t = eng.cache.tiers
                    assert t.counters["spilled_pages"] > 0
                    block = (next(iter(t.host.values()))["k"]
                             if t.host_pages else t.store.get(next(iter(
                                 t.persist_index.values()))["k"]))
                    assert block.shape[2] == cfg.eff_kv_heads
            finally:
                eng.close()


@pytest.mark.parametrize("name,extra", [
    ("trace", {}), ("trace", {"step_mode": "interleaved"}),
    ("pressure", {}), ("pressure", {"step_mode": "interleaved"}),
    ("int8", {}), ("untied-whole", {}), ("trace", {"speculative": "ngram"}),
    ("mamba2", {}), ("zamba2", {}),
], ids=["trace-fused", "trace-interleaved", "pressure-fused",
        "pressure-interleaved", "int8", "untied-whole", "ngram", "mamba2",
        "zamba2"])
def test_tp2_streams_equal_jax_engine(mesh2, jax_streams, name, extra):
    arch, kind, kw, reqs = SCENARIOS[name]
    cfg = reduced(ARCHS[arch])
    cls = SSMEngine if kind == "ssm" else ContinuousBatchingEngine
    with serving_mesh_scope(mesh2):
        eng = cls(cfg, _params(arch), device="cpu", **kw, **extra)
    assert eng.executor.tp == 2
    assert eng.executor.vocab_sharded == (not cfg.tie_embeddings)
    # mamba2: a snapshot preemption parks and restores every rank's slice
    got = _serve(eng, reqs, preempt_at=4 if name == "mamba2" else None)
    eng.close()
    ref = jax_streams()[name]
    assert ref["tp"] == 1
    assert got == ref["streams"]
    if name == "pressure":
        assert eng.stats["preemptions"] >= 1
        assert eng.cache.stats["prefix_hits"] >= 1
    if name == "mamba2":
        assert eng.stats["restores"] == 1
    if "speculative" in extra:
        assert eng.stats["spec_bundles"] > 0
    if name == "trace" and not extra:
        # JAX's own 2-device sharded engine gives the same streams
        sharded = jax_streams()["trace-sharded"]
        assert sharded["tp"] == 2 and sharded["streams"] == got
