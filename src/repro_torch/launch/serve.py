"""Serve launcher: ``python -m repro_torch.launch.serve --arch <id> [--device cpu]``.

Boots the engine with a reduced config, replays a batch of JSON requests
through Blaze admission, and reports latency breakdowns.
"""

from __future__ import annotations

import argparse
import json
import time


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-8b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-tokens", type=int, default=8)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    import torch

    from ..configs import get_config
    from ..core.batch_executor import resolve_device
    from ..models import Model
    from ..serve.engine import ServeConfig, ServeEngine

    cfg = get_config(args.arch).reduced()
    model = Model(cfg)
    device = resolve_device(args.device)
    params = model.init(torch.Generator(device).manual_seed(0))
    engine = ServeEngine(
        cfg, params,
        ServeConfig(batch_slots=4, max_len=128, default_max_tokens=args.max_tokens),
        device=device,
    )
    t0 = time.time()
    for i in range(args.requests):
        body = {"prompt": f"request {i}: the quick brown fox", "max_tokens": args.max_tokens}
        if i % 4 == 3:
            body["bad_field"] = 1  # rejected by the closed request schema
        rid, err = engine.submit(json.dumps(body))
        print(f"[serve] submit {i}: {'id=' + str(rid) if rid is not None else 'REJECTED ' + err}")
    results = engine.run_until_drained()
    dt = time.time() - t0
    s = engine.stats
    print(
        f"[serve] completed={s.completed}/{s.admitted} rejected={s.rejected} "
        f"decode_steps={s.decode_steps} wall={dt:.2f}s "
        f"validation_total={s.validation_seconds*1e6:.0f}us "
        f"({s.validation_seconds/max(s.received,1)*1e6:.1f}us/request)"
    )


if __name__ == "__main__":
    main()
