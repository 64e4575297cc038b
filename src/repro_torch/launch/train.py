"""Fault-tolerant training driver: the paper's pipeline, end to end.

The training run is expressed as a Jup2Kub workflow of four steps —

    prepare_data -> train (long-running, checkpointed) -> evaluate -> report

— scheduled by WorkflowScheduler with heartbeats, retries and (optionally)
chaos injection. The train step checkpoints every ``--ckpt-every`` steps and
resumes from the latest checkpoint after a pod death; the data pipeline
replays deterministically from the restored step.

The model trains on ``--device`` (``cuda`` by default: attention through
the flash kernel's forward inside its autograd Function; ``--attn-impl
ref`` forces the plain version there too; ``--device cpu`` runs the plain
versions on the CPU, for tests and reduced configs):

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
      --reduced --device cpu --steps 60 --chaos

Each train attempt records its device memory at its start, its step
seconds and its checkpoint save and restore seconds and bytes into the
run's stats (:func:`run`'s third result; printed as the ``train_stats:``
line).
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch


def _allocated(device: torch.device) -> int | None:
    """Device bytes allocated by tensors, or None off the card."""
    if device.type != "cuda":
        return None
    torch.cuda.synchronize(device)
    return torch.cuda.memory_allocated(device)


def _dir_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.iterdir() if f.is_file())


def build_workflow(args, workdir: Path, cfg=None, stats: dict | None = None):
    """The four-step graph. ``cfg`` overrides the config ``args.arch`` (and
    ``--reduced``) name; ``stats["attempts"]`` receives one record per
    train attempt."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_arch, reduced
    from repro_torch.core.dag import Step, StepGraph
    from repro_torch.data import DataConfig, SyntheticCorpus
    from repro_torch.models import build_model
    from repro_torch.models.common import flatten_tree, resolve_device, tree_map
    from repro_torch.train import AdamWConfig, init_train_state, make_train_step
    from repro_torch.train.step import abstract_train_state, make_eval_step

    if cfg is None:
        cfg = get_arch(args.arch)
        if args.reduced:
            cfg = reduced(cfg)
    device = resolve_device(args.device)
    attn_impl = getattr(args, "attn_impl", "auto")
    opt_cfg = AdamWConfig(
        lr=args.lr, warmup_steps=10, decay_steps=max(args.steps * 4, 100),
        weight_decay=0.0, moment_dtype="float32",
    )
    attempts = (stats if stats is not None else {}).setdefault("attempts", [])

    def on_device(batch: dict) -> dict:
        return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}

    def restore_into(model, ckpt, like, step=None):
        """Restore ``like``'s leaves to the device; the parameters become
        the model's own (shared, not copied)."""
        state, meta = ckpt.restore(like, step=step)
        state = tree_map(lambda x: x.to(device), state)
        model.load_params(flatten_tree(state["params"]))
        return state, meta

    # ---------------- step fns ----------------
    def prepare_data(inputs):
        dc = DataConfig(
            vocab_size=cfg.vocab_size, seq_len=args.seq_len,
            global_batch=args.batch, seed=args.seed,
            vision_tokens=cfg.num_frontend_tokens if cfg.family == "vlm" else 0,
            frames=cfg.is_encoder_decoder, d_model=cfg.d_model, dtype=cfg.dtype,
        )
        return {"data_config": dc}

    def train(inputs, ctx):
        rec = {"attempt": ctx.attempt, "memory_start": _allocated(device),
               "start_step": 0, "step_s": [], "save_s": [], "save_bytes": [],
               "restore_s": None, "restore_bytes": None}
        attempts.append(rec)
        dc = inputs["data_config"]
        corpus = SyntheticCorpus(dc)
        model = build_model(cfg, device=device, attn_impl=attn_impl)
        step_fn = make_train_step(model, opt_cfg, ga=args.ga)
        ckpt = CheckpointManager(ctx.claim_path or workdir / "ckpt", keep=2)

        start = ckpt.latest_step()
        if start is not None:
            t0 = time.perf_counter()
            state, meta = restore_into(
                model, ckpt, abstract_train_state(model, opt_cfg), step=start)
            _allocated(device)  # the copies to the card have landed
            rec.update(restore_s=time.perf_counter() - t0,
                       restore_bytes=_dir_bytes(ckpt._step_dir(start)),
                       start_step=start)
            losses = list(meta.get("losses", []))
            ctx.beat(progress=start, info="restored")
        else:
            state = init_train_state(model, args.seed, opt_cfg)
            losses = []
            start = 0

        for i in range(start, args.steps):
            batch = on_device(corpus.batch_at(i))
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            losses.append(float(metrics["loss"]))  # waits for the step
            rec["step_s"].append(time.perf_counter() - t0)
            ctx.beat(progress=i + 1, loss=losses[-1])  # liveness + kill point
            if (i + 1) % args.ckpt_every == 0 or i + 1 == args.steps:
                t0 = time.perf_counter()
                ckpt.save(i + 1, state, meta={"losses": losses}, sync=True)
                rec["save_s"].append(time.perf_counter() - t0)
                rec["save_bytes"].append(_dir_bytes(ckpt._step_dir(i + 1)))
        return {"losses": losses, "final_step": args.steps,
                "ckpt_dir": str(ckpt.root)}

    def evaluate(inputs, ctx):
        dc = inputs["data_config"]
        corpus = SyntheticCorpus(dc)
        model = build_model(cfg, device=device, attn_impl=attn_impl)
        ckpt = CheckpointManager(inputs["ckpt_dir"])
        # only the parameters: the moments are not needed to evaluate
        like = {"params": abstract_train_state(model, opt_cfg)["params"]}
        state, _ = restore_into(model, ckpt, like)
        eval_fn = make_eval_step(model)
        tot = 0.0
        n_eval = 4
        for i in range(n_eval):
            batch = on_device(corpus.batch_at(10_000 + i))
            tot += float(eval_fn(state["params"], batch)["loss"])
        return {"eval_loss": tot / n_eval}

    def report(inputs):
        losses = inputs["losses"]
        rep = {
            "arch": cfg.name,
            "steps": inputs["final_step"],
            "first_loss": losses[0],
            "last_loss": losses[-1],
            "eval_loss": inputs["eval_loss"],
            "improved": bool(losses[-1] < losses[0]),
        }
        (workdir / "report.json").write_text(json.dumps(rep, indent=1))
        return {"report": rep}

    steps = {
        "prepare_data": Step("prepare_data", fn=prepare_data,
                             reads=set(), writes={"data_config"}, replicas=1),
        "train": Step("train", fn=train, reads={"data_config"},
                      writes={"losses", "final_step", "ckpt_dir"},
                      long_running=True, max_attempts=6),
        "evaluate": Step("evaluate", fn=evaluate,
                         reads={"data_config", "ckpt_dir"},
                         writes={"eval_loss"}, replicas=2),
        "report": Step("report", fn=report,
                       reads={"losses", "final_step", "eval_loss"},
                       writes={"report"}, replicas=1),
    }
    edges = {
        ("prepare_data", "train"): {"data_config"},
        ("prepare_data", "evaluate"): {"data_config"},
        ("train", "evaluate"): {"ckpt_dir"},
        ("train", "report"): {"losses", "final_step"},
        ("evaluate", "report"): {"eval_loss"},
    }
    return StepGraph(steps=steps, edges=edges).validate()


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--ga", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--chaos", action="store_true",
                    help="kill the train pod twice mid-run; FT must recover")
    ap.add_argument("--workdir", default="experiments/train_run")
    ap.add_argument("--device", default="cuda",
                    help="where the model and train state live ('cuda' needs "
                         "a card; 'cpu' runs the plain attention version)")
    ap.add_argument("--attn-impl", default="auto", choices=("auto", "ref"),
                    help="'ref': the plain attention version on any device")
    return ap.parse_args(argv)


def run(args, cfg=None):
    """Build and schedule the workflow; returns (the workflow's artifacts:
    ``report``, the per-step ``losses`` ..., the scheduler, the stats)."""
    from repro_torch.core import ArtifactStore, TopicBus, WorkflowScheduler
    from repro_torch.core.faults import FaultInjector, KillRule
    from repro_torch.core.scheduler import RetryPolicy

    workdir = Path(args.workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    stats: dict = {}
    graph = build_workflow(args, workdir, cfg=cfg, stats=stats)
    bus = TopicBus(workdir / "bus")
    store = ArtifactStore(workdir / "store")

    faults = None
    if args.chaos:
        faults = FaultInjector(
            [KillRule(step="train", after_s=1.0, times=2)]
        )
    claim = store.claim("train-ckpt", tier="shared")
    sched = WorkflowScheduler(
        graph, bus, store,
        workflow=f"train-{args.arch}",
        retry=RetryPolicy(max_attempts=6, backoff_s=0.1),
        liveness_window_s=30.0,
        fault_injector=faults,
        claim_paths={"train": str(claim.path)},
        device=args.device,
    )
    arts = sched.run(timeout_s=3600)
    return arts, sched, stats


def main(argv=None) -> int:
    args = parse_args(argv)
    t0 = time.time()
    arts, sched, stats = run(args)
    rep = arts["report"]
    print(json.dumps(rep, indent=1))
    print(f"wall: {time.time()-t0:.1f}s")
    kinds = [e["kind"] for e in sched.events.history()]
    print("events:", {k: kinds.count(k) for k in sorted(set(kinds))})
    print("train_stats:", json.dumps(stats))
    assert rep["improved"], "training did not reduce loss"
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
