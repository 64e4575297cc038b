"""The port's public serving surface against the reviewed snapshot of the
JAX package's (``tools/serving_api.txt``).

``tools/check_api.py`` (loaded as it is, its ``MODULE`` pointed at
``repro_torch.serving``) renders the port's exports. The snapshot with
exactly the edits of :data:`ALLOWED` applied, each an intended difference
with its reason, must equal that render: a name or property the port lacks
(``PagedKVCache.k_pages`` once did), or a signature drift no edit names,
fails with the diff.
"""

import difflib
import importlib.util
from pathlib import Path

import pytest

pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
DEVICE = ", device='cuda')"

# (text of the snapshot, what the port renders there, why)
ALLOWED = [
    ("surface of repro.serving (", "surface of repro_torch.serving (",
     "the module rendered is the port's"),
    ("draft_config=None, draft_params=None)\n",
     "draft_config=None, draft_params=None" + DEVICE + "\n",
     "ContinuousBatchingEngine takes its device: cuda unless the caller "
     "asks for cpu"),
    ("  ContinuousBatchingEngine.drain_rejections",
     "  ContinuousBatchingEngine.close(self) -> 'None'\n"
     "  ContinuousBatchingEngine.drain_rejections",
     "close() releases the executor on a mesh's followers"),
    ("chunk: 'int' = 32, attn_impl: 'str | None' = None)\n",
     "chunk: 'int' = 32, attn_impl: 'str | None' = None" + DEVICE + "\n",
     "the draft model runs on the engine's device"),
    ("admission: 'AdmissionPolicy | None' = None)\n",
     "admission: 'AdmissionPolicy | None' = None, attn_impl: 'str | None' "
     "= None, ssd_impl: 'str | None' = None" + DEVICE + "\n",
     "the lockstep engine takes the kernel-or-plain choice and its device"),
    ("  GenerationEngine.drain_rejections",
     "  GenerationEngine.close(self) -> 'None'\n"
     "  GenerationEngine.drain_rejections",
     "close() on every engine, for one engine protocol"),
    ("head_dim: 'int', dtype, max_slots",
     "head_dim: 'int', dtype: 'torch.dtype', max_slots",
     "the pool's dtype is a torch dtype"),
    ("tiers: 'KVTierManager | None' = None)\n",
     "tiers: 'KVTierManager | None' = None" + DEVICE + "\n",
     "the page pool lives on a device"),
    ("device_row(self, slot: 'int') -> 'jax.Array'",
     "device_row(self, slot: 'int') -> 'torch.Tensor'",
     "device arrays are torch tensors"),
    ("device_tables(self) -> 'tuple[jax.Array, jax.Array]'",
     "device_tables(self) -> 'tuple[torch.Tensor, torch.Tensor]'",
     "device arrays are torch tensors"),
    ("  PagedKVCache.set_pages(self, k_pages: 'jax.Array', v_pages: "
     "'jax.Array') -> 'None'\n", "",
     "no set_pages: every writer writes the pool in place (k_pages/v_pages "
     "setters)"),
    ("  PagedKVCache.swap_pages(self, pages: 'dict[str, jax.Array]') -> "
     "'None'\n", "",
     "no swap_pages: the model's paged steps write the pool in place"),
    ("ssd_impl: 'str | None' = None)\n  SSMEngine.abort_all",
     "ssd_impl: 'str | None' = None" + DEVICE + "\n  SSMEngine.abort_all",
     "SSMEngine takes its device"),
    ("  SSMEngine.drain_rejections",
     "  SSMEngine.close(self) -> 'None'\n  SSMEngine.drain_rejections",
     "close() releases the executor on a mesh's followers"),
    ("class SlotStateBank(self, cfg, max_slots: 'int', dtype) -> 'None'\n"
     "  SlotStateBank.commit(self, state: 'dict') -> 'None'\n"
     "  SlotStateBank.restore(self, slot: 'int', snap: 'dict[str, "
     "np.ndarray]') -> 'None'\n"
     "  SlotStateBank.snapshot(self, slot: 'int') -> 'dict[str, "
     "np.ndarray]'\n",
     "class SlotStateBank(self, cfg, max_slots: 'int', dtype: "
     "'torch.dtype', device='cuda', mesh=None) -> 'None'\n"
     "  SlotStateBank.put(self, slot: 'int', new: 'dict[str, "
     "torch.Tensor]') -> 'None'\n"
     "  SlotStateBank.restore(self, slot: 'int', snap: 'dict[str, "
     "torch.Tensor]') -> 'None'\n"
     "  SlotStateBank.slot(self, slot: 'int') -> 'dict[str, "
     "torch.Tensor]'\n"
     "  SlotStateBank.snapshot(self, slot: 'int') -> 'dict[str, "
     "torch.Tensor]'\n"
     "  SlotStateBank.zero(self, slot: 'int') -> 'None'\n",
     "the bank is written in place (put/slot/zero, no commit) and holds "
     "one rank's slice on a mesh"),
    ("seed: 'int' = 0, attn_impl: 'str | None' = None)\n",
     "seed: 'int' = 0, attn_impl: 'str | None' = None" + DEVICE + "\n",
     "build_proposer passes the engine's device to the draft"),
]


def _check_api():
    spec = importlib.util.spec_from_file_location(
        "check_api", REPO / "tools" / "check_api.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.MODULE = "repro_torch.serving"
    return mod


def test_port_surface_is_the_snapshot_with_the_allowed_differences():
    want = (REPO / "tools" / "serving_api.txt").read_text()
    for old, new, why in ALLOWED:
        assert want.count(old) == 1, f"edit {why!r} does not apply once"
        want = want.replace(old, new)
    got = _check_api().render()
    diff = "".join(difflib.unified_diff(
        want.splitlines(keepends=True), got.splitlines(keepends=True),
        fromfile="snapshot + ALLOWED", tofile="repro_torch.serving"))
    assert got == want, f"unreviewed drift of the port's surface:\n{diff}"


def test_paged_cache_keeps_the_reference_pool_properties():
    """ROADMAP C.13: the pool's ``k_pages`` / ``v_pages`` with setters."""
    from repro_torch.serving import PagedKVCache

    for name in ("k_pages", "v_pages"):
        prop = getattr(PagedKVCache, name)
        assert isinstance(prop, property) and prop.fset is not None
