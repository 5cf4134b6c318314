"""llmctl: manage model -> endpoint mappings in the discovery store.

Copied from dynamo_tpu/llmctl.py. `add` writes the registry key the
frontend's model watcher reads (frontend/discovery.py `register_model`,
`models/{type}/{name}` with the card), `list` prints every entry and
`remove` deletes a model's keys. A frontend that watches the registry
serves an added alias from the named endpoint's workers at once, and
answers 404 for it once it is removed.

Usage:
  python -m dynamo_tpu_torch.llmctl [--control-host H --control-port P] list
  python -m dynamo_tpu_torch.llmctl add <name> <ns.component.endpoint> \\
      [--arch llama3-8b] [--model-type chat] [--kv-routed]
  python -m dynamo_tpu_torch.llmctl remove <name> [--model-type both]
`--control-host` takes an HA pair in the comma form, h1:p1,h2:p2.
`--arch` is any model of the registry (engine/config.py).
"""
from __future__ import annotations

import argparse
import asyncio

from dynamo_tpu_torch.engine.config import _CONFIGS
from dynamo_tpu_torch.frontend.discovery import (
    list_registered_models, register_model, unregister_model,
)
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.utils.logconfig import configure_logging


async def amain(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--control-host", default="127.0.0.1")
    p.add_argument("--control-port", type=int, default=5550)
    sub = p.add_subparsers(dest="cmd", required=True)

    sub.add_parser("list", help="list registered models")

    pa = sub.add_parser("add", help="register a model->endpoint mapping")
    pa.add_argument("name")
    pa.add_argument("endpoint", help="ns.component.endpoint")
    pa.add_argument("--arch", default="tiny", choices=sorted(_CONFIGS))
    pa.add_argument("--model-type", default="chat",
                    choices=("chat", "completion", "both"))
    pa.add_argument("--kv-routed", action="store_true")

    pr = sub.add_parser("remove", help="unregister a model")
    pr.add_argument("name")
    # removal defaults to every type key: a card registered as "both" (a
    # checkpoint's) would otherwise leave a half behind
    pr.add_argument("--model-type", default="both",
                    choices=("chat", "completion", "both"))

    args = p.parse_args(argv)
    configure_logging()
    runtime = await DistributedRuntime.connect(
        args.control_host, args.control_port)
    try:
        if args.cmd == "list":
            models = await list_registered_models(runtime.kv)
            for key, payload in sorted(models.items()):
                print(f"{key}\t{payload['namespace']}."
                      f"{payload['component']}.{payload['endpoint']}\t"
                      f"kv_routed={payload.get('kv_routed', False)}")
            if not models:
                print("(no models registered)")
        elif args.cmd == "add":
            try:
                ns, comp, ep = args.endpoint.split(".", 2)
            except ValueError:
                raise SystemExit("endpoint must be ns.component.endpoint")
            card = ModelDeploymentCard(name=args.name, arch=args.arch,
                                       model_type=args.model_type)
            await register_model(runtime.kv, args.name, ns, comp, card,
                                 endpoint=ep, model_type=args.model_type,
                                 kv_routed=args.kv_routed)
            print(f"added {args.model_type} model {args.name} -> "
                  f"{args.endpoint}")
        elif args.cmd == "remove":
            await unregister_model(runtime.kv, args.name, args.model_type)
            print(f"removed {args.model_type} model {args.name}")
    finally:
        await runtime.shutdown()


def main(argv=None) -> None:
    asyncio.run(amain(argv))


if __name__ == "__main__":
    main()
