"""Training driver: ``python -m repro_torch.launch.train --arch <id> [--device cpu]``.

Wires together config -> mesh -> sharded train step -> admission pipeline
-> supervised loop (checkpoint/restart, NaN rollback, straggler watch).
It trains on a mesh of one device (``make_host_mesh``), the card unless
``--device cpu`` is given: reduced configs by default, the published
widths with ``--full``.
"""

from __future__ import annotations

import argparse
import itertools
import json
import tempfile
from pathlib import Path

import numpy as np


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--reduced", action="store_true", default=True,
                    help="use the smoke-scale config (CPU default)")
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--ckpt-dir",
                    default=str(Path(tempfile.gettempdir()) / "repro_torch_ckpt"))
    ap.add_argument("--checkpoint-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from ..configs import get_config
    from ..core.batch_executor import resolve_device
    from ..data.corpus import make_dataset
    from ..data.pipeline import ShardedPipeline
    from ..models import Model
    from ..sharding.rules import device_put
    from ..train import optimizer as opt
    from ..train.checkpoint import CheckpointManager
    from ..train.supervisor import SupervisorConfig, TrainSupervisor
    from ..train.train_step import make_train_step
    from .mesh import make_host_mesh

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = Model(cfg)
    print(f"[train] arch={cfg.name} params={cfg.param_count()/1e6:.1f}M "
          f"(active {cfg.active_param_count()/1e6:.1f}M)")

    device = resolve_device(args.device)
    mesh = make_host_mesh(device)
    ocfg = opt.OptimizerConfig(
        learning_rate=1e-3, warmup_steps=5, total_steps=args.steps,
        state_dtype=cfg.optimizer_state_dtype,
    )
    step, (psh, osh, bsh), _ = make_train_step(
        model, ocfg, mesh, batch=args.batch, donate=False
    )
    params = device_put(model.init(torch.Generator(device).manual_seed(0)), psh)
    opt_state = device_put(opt.init(ocfg, params), osh)

    ds = make_dataset("driver-corpus", 2000, 6.0, 350, seed=11)
    records = [{"text": json.dumps(d)} for d in ds.documents]
    schema = {"type": "object", "required": ["text"],
              "properties": {"text": {"type": "string", "minLength": 4}}}
    pipe = ShardedPipeline(schema, records, seq_len=args.seq_len, batch_size=args.batch,
                           device=device)

    def wrapped(p, s, b):
        prefix = None
        if cfg.prefix_len:
            prefix = torch.zeros((args.batch, cfg.prefix_len, cfg.d_model),
                                 dtype=cfg.dtype(), device=device)
        data = {"tokens": torch.as_tensor(b["tokens"] % cfg.vocab_size, device=device),
                "labels": torch.as_tensor(b["labels"] % cfg.vocab_size, device=device)}
        if prefix is not None:
            data["prefix"] = prefix
        return step(p, s, data)

    mgr = CheckpointManager(Path(args.ckpt_dir) / cfg.name, keep=2, device=device)
    sup = TrainSupervisor(
        wrapped, mgr, SupervisorConfig(checkpoint_every=args.checkpoint_every)
    )
    start, params, opt_state = sup.resume_or_init(params, opt_state)
    if start:
        print(f"[train] resumed from step {start}")
    # main keeps no reference to the first state: the call moves the popped
    # trees into run's frame (CPython 3.11+), which rebinds them after the
    # first step, so with donate=False they are freed then and not held for
    # the whole run (30.6 GB at rwkv6-3b's full width)
    first = {"params": params, "opt_state": opt_state}
    del params, opt_state
    params, opt_state, hist = sup.run(
        first.pop("params"), first.pop("opt_state"), itertools.cycle(pipe.batches()),
        start_step=start, num_steps=args.steps,
    )
    ok = [r for r in hist if np.isfinite(r.loss)]
    print(
        f"[train] steps={len(hist)} loss {ok[0].loss:.3f} -> {ok[-1].loss:.3f} | "
        f"admission: {pipe.admission.stats.admitted} in / "
        f"{pipe.admission.stats.rejected} rejected | "
        f"stragglers={sum(r.straggler for r in hist)}"
    )


if __name__ == "__main__":
    main()
