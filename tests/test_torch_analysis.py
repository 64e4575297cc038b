"""The port's dry run (ROADMAP A.13) against the JAX package's, on the CPU.

``repro_torch.analysis`` (the roofline, the meta-tensor step counter) and
``repro_torch.launch.{builders,dryrun}`` against ``repro.analysis`` and
``repro.launch``:

* the roofline arithmetic (the port of ``tests/test_sharding_hlo.py``'s
  ``test_roofline_terms_math``, with explicit H100 numbers) and JAX's
  ``roofline_terms`` on the same counts;
* the counter on programs worked by hand: a Python loop of L matmuls is
  exactly L * 2MKN; ``torch.utils.checkpoint``'s recompute is counted; the
  peak tracker on a sequence of allocations and releases; a kernel region
  charges only its inputs and outputs and holds only its outputs; the
  ops route meta tensors to the kernels' stand-ins;
* FLOPs against ``analyze_hlo`` of JAX's ``lower_cell`` on one CPU
  device, reduced configs of all 10 archs at B 8 x S 64: prefill and
  decode equal; train equal to JAX's plus and minus four named terms
  (below), at ``ga`` 1 and, for llama3, at ``ga`` 2 (the microbatch
  counted twice, the update once, as JAX's scan counts them);
* a train step of ``ga`` 2 counted in its parts equals the count of the
  whole step;
* each rank's argument bytes equal JAX's
  ``memory_analysis().argument_size_in_bytes``, on one device in this
  process and on a (data 2, model 2) mesh in one subprocess with four
  forced host devices;
* the analytic collectives of reduced llama3 on that mesh against the
  compiled step's, operand for operand, by kind and mesh axis;
* ``make_production_mesh`` against JAX's ``describe_mesh``, no process
  spawned; ``dryrun.run_cell`` on one full-width arch per family on the
  single-pod mesh (a record with JAX's keys) and JAX's skip reason.

The train step's FLOPs, port = JAX + (a) + (b) - (c) - (d), exactly:

(a) the Functions' recompute: on the card, and so on meta tensors,
    attention and the SSD scan train through ``FlashAttentionFunction`` /
    ``SSDScanFunction``, whose backward recomputes the plain forward under
    autograd; JAX differentiates its scan directly. One more plain forward
    a call: half the FLOPs counted inside kernel regions (each region runs
    twice, in the forward and in ``torch.utils.checkpoint``'s recompute);
(b) the cross-entropy's logits: ``chunked_cross_entropy`` recomputes each
    chunk's logits in backward (``torch.utils.checkpoint``); XLA merges the
    recompute with the forward's product when the unembedding is untied.
    One (B*S, D) x (D, Vp) product, for every untied arch;
(c) products XLA runs as dots and eager PyTorch as an elementwise product
    and a sum (FlopCounterMode counts neither): in the Mamba2 block's
    backward, three (B*S*H, P) contractions a layer (the gradients of the
    per-head scalings ``x * dt`` and ``D * x``);
(d) the hybrid's recompute of the last Mamba layer's out projection in
    each group, a (B*S, d_inner) x (d_inner, D) product:
    ``torch.utils.checkpoint`` stops recomputing a group once the tensors
    its backward saved are back, and ``w_out``'s product, whose output is
    the group's and is read by no backward, comes after the last of them;
    JAX recomputes the group's inner ``jax.lax.scan`` over its Mamba layers
    whole, every iteration's ``w_out`` included (a dot census of the two
    steps, size by size, differs only there and in (a)-(c)). A
    per-layer checkpoint (dense, moe, ssm) skips the same last product in
    both: XLA drops it from the rematerialized layer.

So train/JAX is 1.04 (smollm, tied) to 1.10 (mamba2) for the reduced
configs; every term is asserted to the FLOP.

The collectives (``builders.collective_terms``) of reduced llama3 on
(data 2, model 2), against the compiled step's operands, summed by kind
and by the mesh axis of their replica groups (scalar operands, the loss's
metrics, left out): the FSDP gathers, the gradients' reductions (XLA on
the CPU runs a reduce-scatter as an all-reduce) and, on the model axis,
the blocks' sums, the embedding's, the unembedding's input gradient and
the cross-entropy's statistics are equal, but for one named term: XLA
all-reduces the gradient of each projection's input apart (q, k, v;
gate, up), 3 activations a layer and microbatch more than the port's plan,
which sums them and reduces once a block. Not in the port's plan, and not
asserted: the int32 token slices XLA exchanges to split a batch into
microbatches (an all-to-all), the prefill's cache resharding and its
logits left vocab-sharded (the port gathers one position's), and the
decode step, whose attention XLA splits over the cache's sequence shards
(``cache_seq -> model``) where the port's plan splits heads.
"""

import dataclasses
import functools
import json
import multiprocessing
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import Mesh as JMesh
from torch.utils.checkpoint import checkpoint

from repro.analysis.hlo import HloCost, analyze_hlo
from repro.analysis.roofline import HW as JHW
from repro.analysis.roofline import roofline_terms as j_roofline_terms
from repro.configs import ARCHS as J_ARCHS
from repro.configs import ShapeConfig as JShape
from repro.configs import reduced as j_reduced
from repro.launch.builders import lower_cell as j_lower_cell
from repro.launch.mesh import describe_mesh as j_describe_mesh
from repro_torch.analysis import HW, StepCost, count_step, roofline_terms
from repro_torch.analysis.cost import kernel_region
from repro_torch.configs import ARCHS, ShapeConfig, reduced
from repro_torch.kernels import ops
from repro_torch.launch import builders, dryrun
from repro_torch.launch.mesh import describe_mesh, make_production_mesh
from repro_torch.models.lm import padded_vocab
from repro_torch.parallel import Mesh, Sharding
from repro_torch.parallel.axes import P

REPO = Path(__file__).resolve().parents[1]
KINDS = ("train", "prefill", "decode")
B, S = 8, 64


def _program(arch):
    """The first arch whose reduced config equals ``arch``'s but for its
    name and rope theta (a constant): the same JAX program, compiled once
    for both (grok and dbrx, llama3 and phi3)."""
    key = dataclasses.replace(reduced(ARCHS[arch]), name="", rope_theta=0.0)
    return next(a for a in ARCHS if dataclasses.replace(
        reduced(ARCHS[a]), name="", rope_theta=0.0) == key)


# XLA's code generation at -O0: the same HLO (and so the same analyzer
# counts and argument sizes) in half the compile time
COMPILE = {"xla_backend_optimization_level": 0}
CELLS = [(a, k) for a in ARCHS for k in KINDS]
JAX_CELLS = [(a, k) for a, k in CELLS if _program(a) == a]

# JAX's side on a (data 2, model 2) mesh: four forced host devices
_JAX4_SCRIPT = r"""
import dataclasses, json, re, sys
import numpy as np
import jax
from jax.sharding import Mesh
from repro.analysis import hlo as H
from repro.analysis.hlo import analyze_hlo
from repro.configs import ARCHS, ShapeConfig, reduced
from repro.launch.builders import lower_cell

AXIS = {"[2,2]<=[4]": "model", "[2,2]<=[2,2]T(1,0)": "data"}


def by_axis(text):
    # collective operand bytes by kind and mesh axis, each op times its
    # loops' trip counts; the 0-d operands (the loss's metrics) left out
    comps = H.parse_computations(text)
    entry = next(c for c in comps.values() if c.is_entry)
    mult, todo = {entry.name: 1.0}, [entry.name]
    while todo:
        comp = comps.get(todo.pop())
        if comp is None:
            continue
        for op in comp.ops:
            calls = H._callees(op)
            trip = 1
            if op.kind == "while":
                cond = next(n for n, r in calls if r == "condition")
                trip = H._trip_count(comps[cond])
            for callee, rel in calls:
                m = mult[comp.name] * (trip if op.kind == "while" and rel in
                                       ("body", "condition") else 1)
                if m > mult.get(callee, 0.0):
                    mult[callee] = m
                    todo.append(callee)
    out = {}
    for name, comp in comps.items():
        for op in comp.ops if name in mult else ():
            if op.kind not in H.COLLECTIVES:
                continue
            bare = dataclasses.replace(
                op, args_str=re.sub(r"/\*.*?\*/\s*", "", op.args_str))
            b = sum(H._shape_bytes(t) for t in H._operand_types(bare, comp)
                    if H._shape_dims(t))
            groups = re.search(r"replica_groups=(\S+)", op.attrs)
            axis = AXIS.get(groups.group(1).rstrip(",") if groups else "",
                            "other")
            key = op.kind + "/" + axis
            out[key] = out.get(key, 0.0) + b * mult[name]
    return out


mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
out = {}
for arch, kind, ga in json.load(sys.stdin):
    plan = lower_cell(reduced(ARCHS[arch]), ShapeConfig(kind, %d, %d, kind),
                      mesh, ga=ga)
    compiled = plan.lowered.compile(compiler_options=%r)
    text = compiled.as_text()
    out[arch + "/" + kind + ("" if ga == 1 else "/ga%%d" %% ga)] = {
        "args": compiled.memory_analysis().argument_size_in_bytes,
        "collective_bytes": analyze_hlo(text).collective_bytes,
        "by_axis": by_axis(text)}
print(json.dumps(out))
""" % (S, B, COMPILE)


@pytest.fixture(scope="module", autouse=True)
def jax4(tmp_path_factory):
    """The JAX cells on four devices: two subprocesses (half the
    programs each; ~3 s a compile), started with the module's first test
    so the in-process work overlaps them."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
                         "--xla_cpu_multi_thread_eigen=false",
               PYTHONPATH=str(REPO / "src"))
    cells = [(a, k, 1) for a, k in JAX_CELLS] + [
        (_program("llama3-8b"), "train", 2)]
    procs = []
    for i, part in enumerate((cells[0::2], cells[1::2])):
        out = tmp_path_factory.mktemp("jax4") / f"part{i}.json"
        # at low priority: the test workers share the machine's cores
        proc = subprocess.Popen(["nice", "-n", "10", sys.executable, "-c",
                                 _JAX4_SCRIPT],
                                env=env, stdin=subprocess.PIPE,
                                stdout=out.open("w"), stderr=subprocess.PIPE,
                                text=True)
        proc.stdin.write(json.dumps(part))
        proc.stdin.close()
        procs.append((proc, out))
    done = {}

    def get():
        for proc, out in procs if not done else ():
            err = proc.stderr.read()
            assert proc.wait(timeout=900) == 0, err[-3000:]
            done.update(json.loads(out.read_text().strip().splitlines()[-1]))
        return done

    yield get
    for proc, _ in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: meta tensors hold no data to spread, and the
    test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _shape(kind):
    return ShapeConfig(kind, S, B, kind)


def _meta_mesh(data, model):
    return Mesh(np.full((data, model), "meta", dtype=object),
                ("data", "model"))


def _jax_cell(arch, kind, ga=1):
    """(analyze_hlo FLOPs, argument bytes) of JAX's cell on one device."""
    return _jax_program(_program(arch), kind, ga)


@functools.lru_cache(maxsize=None)
def _jax_program(arch, kind, ga):
    mesh = JMesh(np.array(jax.devices()[:1]).reshape(1, 1),
                 ("data", "model"))
    plan = j_lower_cell(j_reduced(J_ARCHS[arch]), JShape(kind, S, B, kind),
                        mesh, ga=ga)
    compiled = plan.lowered.compile(compiler_options=COMPILE)
    return (analyze_hlo(compiled.as_text()).flops,
            compiled.memory_analysis().argument_size_in_bytes)


@functools.lru_cache(maxsize=None)
def _port_cell(arch, kind, ga=1):
    plan = builders.lower_cell(reduced(ARCHS[arch]), _shape(kind),
                               _meta_mesh(1, 1), ga=ga)
    return plan, builders.count_cell(plan, B // ga)


# ---------------------------------------------------------------------------
# the roofline
# ---------------------------------------------------------------------------


def test_roofline_terms_math():
    hw = HW(peak_flops=989e12, hbm_bw=3.35e12, ici_bw=450e9)
    cost = StepCost(flops=989e12, hbm_bytes=3.35e12,
                    hbm_bytes_kernelized=3.35e12,
                    collective_bytes={"all-reduce": 225e9})
    t = roofline_terms(cost, hw, model_flops_per_chip=494.5e12)
    assert t.compute_s == pytest.approx(1.0)
    assert t.memory_s == pytest.approx(1.0)
    assert t.collective_s == pytest.approx(1.0)  # 2x ring factor
    assert t.useful_flops_ratio == pytest.approx(0.5)
    assert t.dominant in ("compute", "memory", "collective")
    # unkernelized counts fall back to the unfused bytes
    t2 = roofline_terms(StepCost(flops=1.0, hbm_bytes=6.7e12), hw)
    assert t2.memory_s == pytest.approx(2.0) and t2.dominant == "memory"
    assert t2.bound_s == pytest.approx(2.0)


def test_roofline_row_equals_jax_on_the_same_counts():
    """The same arithmetic: JAX's roofline_terms, given the H100's numbers
    and the same counts, gives the same row, key for key."""
    counts = dict(flops=3.1e14, hbm_bytes=2.2e12, hbm_bytes_kernelized=9e11,
                  collective_bytes={"all-reduce": 4e9, "all-gather": 7e9,
                                    "reduce-scatter": 5e9})
    hw = HW()
    jhw = JHW(name=hw.name, peak_flops=hw.peak_flops, hbm_bw=hw.hbm_bw,
              ici_bw=hw.ici_bw, hbm_per_chip=hw.hbm_per_chip)
    ours = roofline_terms(StepCost(**counts), hw, 1e14).as_row()
    theirs = j_roofline_terms(HloCost(**counts), jhw, 1e14).as_row()
    assert ours == theirs and list(ours) == list(theirs)


def test_hw_is_the_h100():
    hw = HW()
    assert (hw.name, hw.peak_flops, hw.hbm_bw, hw.ici_bw, hw.f32_flops) == (
        "h100_sxm", 989e12, 3.35e12, 450e9, 67e12)
    assert 79 * 2**30 < hw.hbm_per_chip < 80 * 2**30


# ---------------------------------------------------------------------------
# the counter on programs worked by hand
# ---------------------------------------------------------------------------


def _meta(*shape, grad=False):
    return torch.empty(shape, device="meta", requires_grad=grad)


def test_loop_of_matmuls_is_exactly_l_times_2mkn():
    L, M, K = 7, 24, 40
    ws = [_meta(K, K) for _ in range(L)]

    def f(x):
        for w in ws:
            x = x @ w
        return x

    c = count_step(f, _meta(M, K))
    assert c.flops == L * 2 * M * K * K
    # each mm reads x and w and writes x: every byte once
    assert c.hbm_bytes == L * 4 * (M * K + K * K + M * K)
    assert c.hbm_bytes == c.hbm_bytes_kernelized and not c.regions
    # two activations live at once, the last one held at the end
    assert c.peak_bytes == 2 * M * K * 4 and c.output_bytes == M * K * 4


def test_checkpoint_recompute_is_counted():
    M, K = 16, 32
    w1, w2 = _meta(K, K, grad=True), _meta(K, K, grad=True)

    def layer(x):
        return torch.relu(x @ w1) @ w2

    def step(x, remat):
        y = checkpoint(layer, x, use_reentrant=False) if remat else layer(x)
        return torch.autograd.grad(y.sum(), (x, w1, w2))

    mm = 2 * M * K * K
    plain = count_step(step, _meta(M, K, grad=True), False)
    remat = count_step(step, _meta(M, K, grad=True), True)
    assert plain.flops == 6 * mm  # two forward products, four backward
    # + the recomputed first product; the recompute stops once the saved
    # tensors are back (the second product's inputs), before the second
    assert remat.flops == 7 * mm


def test_peak_tracker_on_a_hand_worked_sequence():
    def f(x):                # x: 1000 f32, the argument: not counted
        a = x * 2            # +4000 -> 4000
        b = a + 1            # +4000 -> 8000 (the peak)
        del a                # -4000 -> 4000
        c = b[:500] * 3      # a view, then +2000 -> 6000
        d = c.to(torch.float64)  # +4000 -> 10000 (the new peak)
        del c                # -2000 -> 8000
        return d, b[:10]     # b is held by its view: 8000 at the end

    c = count_step(f, _meta(1000))
    assert c.peak_bytes == 10000
    assert c.output_bytes == 8000


def test_kernel_region_charges_inputs_and_outputs_once():
    n = 1024

    def fn(x, y):  # three elementwise ops: two temporaries, one output
        return ((x * 2 + y) * y).sum(dim=0)

    def f(x, y):
        h = x + 1                        # outside: read x, write h
        return kernel_region("k", fn, h, y)

    x, y = _meta(n, n), _meta(n, n)
    c = count_step(f, x, y)
    big, out = n * n * 4, n * 4
    assert c.regions == {"k": 1}
    # kernelized: h's op (2 big), then the region's h and y in, out once
    assert c.hbm_bytes_kernelized == 2 * big + 2 * big + out
    # unfused: every op inside too: mul (2), add (3), mul (3), sum (1 + out)
    assert c.hbm_bytes == 2 * big + (2 + 3 + 3 + 1) * big + out
    # held: h, and the region's output; not its temporaries
    assert c.peak_bytes == big + out
    assert c.region_flops == 0.0
    # outside a count the region is just the call
    assert kernel_region("k", lambda a: a + 1, 1) == 2


def test_ops_route_meta_tensors_to_the_kernels_stand_ins():
    q = _meta(2, 256, 6, 64)
    kv = _meta(2, 256, 2, 64)
    c = count_step(ops.flash_attention, q, kv, kv)
    assert c.regions == {"flash_attention_bhsd": 1}
    assert c.region_flops == 4 * 2 * 256 * 256 * 6 * 64
    # with gradients: FlashAttentionFunction, the stand-in as its forward
    qg = _meta(2, 256, 6, 64, grad=True)
    out = ops.flash_attention(qg, kv, kv)
    assert type(out.grad_fn).__name__ == "FlashAttentionFunctionBackward"
    x, dt, bm = _meta(1, 100, 4, 16), _meta(1, 100, 4), _meta(1, 100, 8)
    c = count_step(ops.ssd_scan, x, dt, _meta(4), bm, bm, chunk=32)
    assert c.regions == {"ssd_scan_bshp": 1}
    c = count_step(ops.ssd_decode_step, _meta(3, 4, 16, 8), _meta(3, 4, 16),
                   _meta(3, 4), _meta(4), _meta(3, 8), _meta(3, 8))
    assert c.regions == {"ssd_decode_step_bh": 1}
    # CPU tensors take the plain versions: no region
    cpu = torch.randn(2, 256, 2, 64)
    c = count_step(ops.flash_attention, cpu, cpu, cpu)
    assert not c.regions and c.flops == 4 * 2 * 256 * 256 * 2 * 64


# ---------------------------------------------------------------------------
# FLOPs and argument bytes against the JAX package
# ---------------------------------------------------------------------------


def _train_terms(cfg, cost):
    """(a), (b), (c) and (d) of the module docstring, in FLOPs, for the
    whole step (B sequences)."""
    recompute = cost.region_flops / 2
    logits = 0 if cfg.tie_embeddings else 2 * B * S * cfg.d_model * \
        padded_vocab(cfg)
    mamba_layers = cfg.num_layers if cfg.family in ("ssm", "hybrid") else 0
    scalings = 3 * mamba_layers * 2 * B * S * cfg.ssm_heads * \
        cfg.ssm_head_dim
    groups = cfg.num_layers // cfg.attn_every if cfg.family == "hybrid" \
        else 0
    last_w_out = groups * 2 * B * S * cfg.d_inner * cfg.d_model
    return recompute, logits, scalings, last_w_out


FLOP_CELLS = [pytest.param(a, k, 1, id=f"{a}-{k}") for a, k in CELLS] + [
    pytest.param("llama3-8b", "train", 2, id="llama3-8b-train-ga2")]


@pytest.mark.parametrize("arch,kind,ga", FLOP_CELLS)
def test_flops_equal_jax_analyzer(arch, kind, ga):
    jflops, _ = _jax_cell(arch, kind, ga)
    plan, cost = _port_cell(arch, kind, ga)
    assert plan.meta["ga"] == ga
    if kind != "train":
        assert cost.flops == pytest.approx(jflops, rel=1e-6)
        return
    recompute, logits, scalings, last_w_out = _train_terms(plan.cfg, cost)
    assert recompute > 0
    assert cost.flops == jflops + recompute + logits - scalings - \
        last_w_out, cost.flops / jflops


@pytest.mark.parametrize("arch", ["llama3-8b", "zamba2-2.7b"])
def test_accumulated_step_counted_in_parts(arch):
    """At ga 2 the dry run counts one microbatch twice and the
    accumulators and the update once: the same FLOPs, bytes, kernel
    regions, peak and arguments read as the count of the whole step the
    trainer runs (``make_train_step``); and the update is counted once:
    the step moves less than twice the one-microbatch step at ga 1."""
    plan, cost = _port_cell(arch, "train", 2)
    whole = count_step(plan.step, *plan.args)
    assert (cost.flops, cost.hbm_bytes, cost.hbm_bytes_kernelized,
            cost.region_flops, cost.regions, cost.peak_bytes,
            cost.output_bytes) == (
        whole.flops, whole.hbm_bytes, whole.hbm_bytes_kernelized,
        whole.region_flops, whole.regions, whole.peak_bytes,
        whole.output_bytes)
    assert builders.used_arguments(plan, cost) == \
        builders.used_arguments(plan, whole)
    plan1 = builders.lower_cell(reduced(ARCHS[arch]), _shape("train"),
                                _meta_mesh(1, 1), ga=1)
    micro1 = builders.count_cell(plan1, B // 2)  # one microbatch + update
    assert cost.flops == 2 * micro1.flops
    assert cost.hbm_bytes < 2 * micro1.hbm_bytes


@pytest.mark.parametrize("arch,kind", CELLS)
def test_argument_bytes_equal_jax_one_device(arch, kind):
    _, jargs = _jax_cell(arch, kind)
    plan, cost = _port_cell(arch, kind)
    used = builders.used_arguments(plan, cost)
    assert builders.argument_bytes(plan, used) == jargs


@pytest.mark.parametrize("arch,kind", CELLS)
def test_argument_bytes_equal_jax_four_devices(jax4, arch, kind):
    plan = builders.lower_cell(reduced(ARCHS[arch]), _shape(kind),
                               _meta_mesh(2, 2), ga=1)
    used = builders.used_arguments(*_port_cell(arch, kind))  # any mesh's
    assert builders.argument_bytes(plan, used) == \
        jax4()[f"{_program(arch)}/{kind}"]["args"]


@pytest.mark.parametrize("kind,ga", [("train", 1), ("train", 2),
                                     ("prefill", 1)])
def test_collectives_equal_jax_by_axis(jax4, kind, ga):
    """The analytic collectives of reduced llama3 on (data 2, model 2)
    against JAX's compiled step, by kind and mesh axis (module docstring):
    equal but for XLA's separate reductions of the projections' input
    gradients. Both sides and JAX's analyzer totals are printed."""
    plan = builders.lower_cell(reduced(ARCHS["llama3-8b"]), _shape(kind),
                               _meta_mesh(2, 2), ga=ga)
    rows = builders.rank_batch(plan)
    ours: dict[str, float] = {}
    for k, axis, _, nbytes, _ in builders.collective_terms(plan, rows):
        ours[f"{k}/{axis}"] = ours.get(f"{k}/{axis}", 0.0) + nbytes
    key = f"{_program('llama3-8b')}/{kind}" + ("" if ga == 1 else f"/ga{ga}")
    theirs = jax4()[key]["by_axis"]
    print(f"\nreduced llama3-8b {kind} ga {ga} B {B} x S {S}, (data 2, "
          f"model 2), per rank: port {ours}; JAX {theirs} (analyzer "
          f"{jax4()[key]['collective_bytes']})")
    cfg = plan.cfg
    act = rows * S * cfg.d_model * 4  # f32
    assert theirs["all-gather/data"] == ours["all-gather/data"]
    if kind == "train":
        assert theirs["all-reduce/data"] == ours["reduce-scatter/data"] + \
            ours["all-reduce/data"]
        apart = ga * 3 * cfg.num_layers * act
        assert theirs["all-reduce/model"] == ours["all-reduce/model"] + apart
    else:
        assert theirs["all-reduce/model"] == ours["all-reduce/model"]


# ---------------------------------------------------------------------------
# the production meshes and the dry run
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("multi", [False, True])
def test_production_mesh_matches_jax(multi):
    before = multiprocessing.active_children()
    mesh = make_production_mesh(multi_pod=multi)
    shape = (2, 16, 16) if multi else (16, 16)
    axes = ("pod", "data", "model") if multi else ("data", "model")
    assert describe_mesh(mesh) == j_describe_mesh(AbstractMesh(shape, axes))
    assert mesh.size == (512 if multi else 256)
    assert {d.type for d in mesh.flat_devices} == {"meta"}
    # sharding over it cuts shapes and starts nothing
    sh = Sharding(mesh, P(("pod", "data") if multi else "data", "model"))
    assert sh.shard_shape((256, 4096)) == ((8 if multi else 16), 256)
    assert mesh._group is None
    assert multiprocessing.active_children() == before


FAMILY_CELLS = [("smollm-360m", "decode_32k"), ("dbrx-132b", "decode_32k"),
                ("internvl2-26b", "decode_32k"), ("mamba2-1.3b", "long_500k"),
                ("zamba2-2.7b", "decode_32k"), ("whisper-tiny", "decode_32k")]
JAX_RECORD_KEYS = {"arch", "shape", "mesh", "tag", "status", "lower_s",
                   "compile_s", "memory", "xla_cost", "analyzer", "roofline",
                   "meta"}


@pytest.mark.parametrize("arch,shape", FAMILY_CELLS)
def test_run_cell_full_width(tmp_path, arch, shape):
    rec = dryrun.run_cell(arch, shape, False, tmp_path)
    assert rec["status"] == "ok", rec.get("trace")
    assert set(rec) == JAX_RECORD_KEYS
    mem = rec["memory"]
    assert {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
            "hbm_needed_bytes", "fits_hbm"} <= set(mem)
    assert mem["hbm_needed_bytes"] == (mem["argument_bytes"]
                                       + mem["resident_bytes"]
                                       + mem["output_bytes"]
                                       + mem["temp_bytes"])
    assert mem["fits_hbm"] == (mem["hbm_needed_bytes"] <= HW().hbm_per_chip)
    assert set(rec["roofline"]) == set(roofline_terms(StepCost()).as_row())
    assert rec["roofline"]["flops"] > 0 and rec["meta"]["ga"] == 1
    on_disk = json.loads(
        (tmp_path / f"{arch}_{shape}_pod16x16.json").read_text())
    assert on_disk["memory"] == mem


def test_run_cell_skips_long_context_of_full_attention(tmp_path):
    from repro.configs import cell_supported, get_arch, get_shape

    rec = dryrun.run_cell("llama3-8b", "long_500k", False, tmp_path)
    ok, reason = cell_supported(get_arch("llama3-8b"), get_shape("long_500k"))
    assert not ok
    assert rec == {"arch": "llama3-8b", "shape": "long_500k",
                   "mesh": "pod16x16", "tag": "", "status": "skip",
                   "reason": reason}


def test_dryrun_cli_counts_each_cell_once_for_both_meshes(tmp_path, capsys):
    dryrun._COUNTS.clear()
    assert dryrun.main(["--arch", "mamba2-1.3b", "--shape", "long_500k",
                        "--mesh", "both", "--out", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "0 failures" in out and "| arch | long_500k |" in out
    assert out.count("| mamba2-1.3b | ") == 2  # a table a mesh
    # batch 1 on both meshes: one microbatch size, one count
    assert len(dryrun._COUNTS) == 1
    assert len(list(tmp_path.glob("*.json"))) == 2


def test_flops_are_flop_counter_modes():
    """The counter applies FlopCounterMode's rules: on a reduced step with
    gradients, checkpointing and kernel regions, the two counts agree."""
    from torch.utils.flop_counter import FlopCounterMode

    plan, cost = _port_cell("zamba2-2.7b", "train")
    mode = FlopCounterMode(display=False)
    with mode:
        plan.step(*plan.args)
    assert cost.flops == mode.get_total_flops() > 0
