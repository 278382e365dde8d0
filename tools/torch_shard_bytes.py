"""The wire bytes a rank puts on each mesh axis in one sharded train step,
predicted on meta: the step runs on a fake world (``torch.distributed``'s
``"fake"`` backend, which moves nothing) and ``dist.sharding.BYTES``
counts every collective by the ring formulas, as it counts them on the
card.  No card, no storage: seconds on the CPU.

    PYTHONPATH=src python3 tools/torch_shard_bytes.py \\
        --arch zamba2-1.2b --layers 7 --batch 4 --seq 512 --mesh 2,2
    PYTHONPATH=src python3 tools/torch_shard_bytes.py \\
        --arch h2o-danube-1.8b --layers 2 --batch 4 --seq 2048 --mesh 4,1 \\
        --rules '{"fsdp": "data"}'

``--rules`` (a JSON object) overrides the placement rules, as
``use_sharding(mesh, rules=...)`` does; ``--reduced`` takes the arch's
reduced widths; ``--mesh`` takes three sizes for a (pod, data, model)
mesh; ``--state-only`` skips the step.  ``--decode POS`` walks one decode
step at position POS instead, over a cache of ``--seq`` slots for a
global batch of ``--batch`` placed by ``LM.cache_specs`` (under
``{"cache_seq": "model"}`` each rank's block of the slots).  Prints one
JSON object: the arch,
the mesh, the rules, the train state's bytes a rank (``state_bytes``:
the params' blocks, their f32 master weights and moments) and ``BYTES``
after the step (``on_model``: the tensor-parallel
collectives, ``on_data``: the gradient mean, and under ``"fsdp"`` the
blocks' gathers and their gradients' reduce-scatters, which gloo runs as
all-reduces and this counts as such).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


class _Done(Exception):
    """The decode walk has its bytes: leave the placement."""


def decode_bytes(model, args) -> dict:
    """``sharding.BYTES`` of one decode step at position ``args.decode``
    under the active placement, on meta: the rank's params and its block
    of the cache, its rows of the token batch."""
    import torch
    from repro_torch.dist import sharding
    from repro_torch.train.train_step import data_rows
    params = sharding.shard_tree(model.init(None), model.param_specs())
    specs = model.cache_specs(args.batch, args.seq)
    cache = model.init_cache(args.batch, args.seq, specs)
    token = data_rows({"t": torch.zeros(args.batch, 1, dtype=torch.int64,
                                        device="meta")})["t"]
    sharding.reset_bytes()
    with torch.no_grad():
        model.decode_step(params, cache, token, args.decode, specs)
    return dict(sharding.BYTES)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--mesh", default="2,2",
                    help="data,model or pod,data,model sizes")
    ap.add_argument("--rules", default=None,
                    help='placement rules over the defaults, JSON, e.g. '
                         '\'{"fsdp": "data"}\'')
    ap.add_argument("--reduced", action="store_true",
                    help="the arch's reduced widths")
    ap.add_argument("--state-only", action="store_true",
                    help="the train state's bytes a rank, no step")
    ap.add_argument("--decode", type=int, default=None, metavar="POS",
                    help="one decode step at position POS over a cache of "
                         "--seq slots, in place of the train step")
    args = ap.parse_args()

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.configs import get_config
    from repro_torch.dist import sharding
    from repro_torch.models import LM
    from repro_torch.train import (TrainState, adamw_init, make_train_step,
                                   require_grad)
    from repro_torch.train.optimizer import leaves

    def nbytes(tree) -> int:
        return sum(x.numel() * x.element_size() for x in leaves(tree))

    shape = tuple(int(x) for x in args.mesh.split(","))
    names = ("data", "model") if len(shape) == 2 else ("pod", "data",
                                                         "model")
    world = math.prod(shape)
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        mesh = DeviceMesh("cpu", torch.arange(world).reshape(shape),
                          mesh_dim_names=names)
        cfg = get_config(args.arch)
        cfg = cfg.reduced() if args.reduced else cfg
        cfg = dataclasses.replace(cfg, n_layers=args.layers or cfg.n_layers,
                                  dtype=args.dtype)
        model = LM(cfg, device="meta")
        rules = json.loads(args.rules) if args.rules else None
        with sharding.use_sharding(mesh, rules):
            if args.decode is not None:
                wire = decode_bytes(model, args)
                held = {}
                raise _Done
            params = require_grad(sharding.shard_tree(model.init(None),
                                                      model.param_specs()))
            state = TrainState(params, adamw_init(params), torch.Generator())
            held = {"params": nbytes(state.params),
                    "master_m_v": sum(nbytes(getattr(state.opt, k))
                                      for k in ("master", "m", "v"))}
            tokens = torch.zeros(args.batch, args.seq, dtype=torch.int64,
                                 device="meta")
            sharding.reset_bytes()
            if not args.state_only:
                make_train_step(model)(state, {"tokens": tokens})
            wire = dict(sharding.BYTES)
    except _Done:
        pass
    finally:
        dist.destroy_process_group()
    print(json.dumps({"arch": cfg.name, "n_layers": cfg.n_layers,
                      "dtype": cfg.dtype, "batch": args.batch,
                      "seq": args.seq, "mesh": list(shape),
                      "rules": rules, "state_bytes": held, "bytes": wire}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
