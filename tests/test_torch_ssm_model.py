"""The port's ssm ``DecoderLM`` against the JAX ``DecoderLM`` on the same
weights.

Reduced mamba2-1.3b in float32 on the CPU: the JAX parameters
(``model.init(jax.random.key(0))``) carried across by ``params_from_jax``;
state banks and tokens from numpy with fixed seeds. Logits and every state
leaf (SSD state and the three conv tails) after ``decode_step_ssm`` (with
idle slots) and ``prefill_chunk_ssm`` (``valid < C`` and ``valid == C``)
are held to 1e-4 against the JAX model on its default (XLA reference) SSD
path.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JARCHS, reduced as jreduced  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.models import build_model, params_from_jax  # noqa: E402
from repro_torch.models.common import flatten_tree  # noqa: E402
from repro_torch.models.ssm import init_mamba_cache  # noqa: E402

TOL = 1e-4
SLOTS = 4


@pytest.fixture(scope="module")
def models():
    jcfg = jreduced(JARCHS["mamba2-1.3b"])
    cfg = reduced(ARCHS["mamba2-1.3b"])
    jmodel = jbuild(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    model = build_model(cfg, device="cpu")
    model.load_state_dict(
        params_from_jax(cfg, jax.tree.map(np.asarray, jparams)))
    return jcfg, jmodel, jparams, cfg, model


def _bank(cfg, slots, seed):
    """A random (L, S, ...) state bank: numpy leaves for both packages."""
    rng = np.random.default_rng(seed)
    mc = init_mamba_cache(cfg, slots, torch.float32, device="meta")
    return {k: rng.standard_normal((cfg.num_layers,) + tuple(v.shape))
            .astype(np.float32) for k, v in mc.items()}


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=TOL, rtol=TOL)


def test_params_from_jax_carries_the_ssm_tree(models):
    """Every ``layers.ln`` / ``layers.mamba.*`` leaf crosses over with its
    name, shape and values; ``init`` covers the same names."""
    jcfg, _, jparams, cfg, model = models
    flat = flatten_tree(jax.tree.map(np.asarray, jparams))
    state = model.state_dict()
    assert set(state) == set(flat)
    assert {"layers.ln", "layers.mamba.w_z", "layers.mamba.a_log",
            "layers.mamba.conv_x", "layers.mamba.w_out"} <= set(state)
    for name, arr in flat.items():
        np.testing.assert_array_equal(state[name].numpy(), arr)
    fresh = build_model(cfg, device="cpu").init(seed=3)
    assert set(fresh) == set(flat)
    assert all(torch.isfinite(v).all() for v in fresh.values())


def test_decode_step_ssm_matches_jax(models):
    """Idle slots (active 0) run but keep their state; the port advances
    its bank in place, the JAX step returns the new bank."""
    jcfg, jmodel, jparams, cfg, model = models
    bank = _bank(cfg, SLOTS, seed=1)
    tokens = np.array([[5], [77], [200], [1]], np.int32)
    active = np.array([1, 0, 1, 0], np.int32)
    jstate, jlogits = jmodel.decode_step_ssm(
        jparams, {k: jnp.asarray(v) for k, v in bank.items()},
        jnp.asarray(tokens), jnp.asarray(active))
    state = {k: torch.from_numpy(v.copy()) for k, v in bank.items()}
    logits = model.decode_step_ssm(state, torch.from_numpy(tokens),
                                   torch.from_numpy(active))
    _close(logits, jlogits)
    for k in bank:
        _close(state[k], jstate[k])
        idle = state[k][:, active == 0].numpy()
        np.testing.assert_array_equal(idle, bank[k][:, active == 0])


@pytest.mark.parametrize("valid", [13, 32])
def test_prefill_chunk_ssm_matches_jax(models, valid):
    """One 32-token chunk continuing from a carried state, partly padded
    (valid 13) and full (valid 32); the conv tails carry from ``valid``."""
    jcfg, jmodel, jparams, cfg, model = models
    bank = _bank(cfg, 1, seed=2 + valid)
    toks = np.random.default_rng(valid).integers(
        1, cfg.vocab_size, 32).astype(np.int32)
    jstate, jlogits = jmodel.prefill_chunk_ssm(
        jparams, {k: jnp.asarray(v) for k, v in bank.items()},
        jnp.asarray(toks), jnp.int32(valid))
    state = {k: torch.from_numpy(v.copy()) for k, v in bank.items()}
    new, logits = model.prefill_chunk_ssm(state, torch.from_numpy(toks),
                                          valid)
    _close(logits, jlogits)
    for k in bank:
        _close(new[k], jstate[k])
        np.testing.assert_array_equal(state[k].numpy(), bank[k])


def test_hybrid_family_is_not_ported_yet():
    """The hybrid family is ported now: it builds, with the ssm family's
    stacked Mamba tree plus the unstacked shared block, and runs the
    recurrent-state entry points' hybrid forms
    (``tests/test_torch_hybrid_model.py`` holds them against JAX). The moe
    family is still refused by its ROADMAP label."""
    cfg = reduced(ARCHS["zamba2-2.7b"])
    model = build_model(cfg, device="cpu")
    specs = flatten_tree(model.param_specs())
    ssm_specs = flatten_tree(
        build_model(reduced(ARCHS["mamba2-1.3b"]), device="cpu").param_specs())
    assert {n for n in specs if n.startswith("layers.")} == set(
        n for n in ssm_specs if n.startswith("layers."))
    assert {n.split(".")[1] for n in specs if n.startswith("shared.")} == {
        "ln1", "attn", "ln2", "mlp"}
    assert callable(model.decode_step_hybrid)
    assert callable(model.prefill_chunk_hybrid)
    with pytest.raises(NotImplementedError, match="A.7"):
        build_model(reduced(ARCHS["dbrx-132b"]), device="cpu")
