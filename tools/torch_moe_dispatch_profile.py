#!/usr/bin/env python3
"""The kernels of the MoE dispatch (``repro_torch.models.moe._dispatch``)
at qwen2-moe-a2.7b's prefill shape on one GPU, by the profiler.

    PYTHONPATH=src python3 tools/torch_moe_dispatch_profile.py [T D E K]

Defaults: T = 8192 tokens (8 prompts of 1024), D = 2048, E = 60 experts,
K = 4 choices a token, the capacity ``_capacity`` gives them (688).  Two
warm-up calls, then one call under ``torch.profiler``; prints the card's
name and power limit, then the device ms of each kernel and of each aten
op, largest first, then the pairs' position scan both ways by CUDA
events: along the outer dimension of the (T·k, E) one-hot, as the
reference writes it, and along the inner dimension of its (E, T·k)
transpose, as the port does.
"""

from __future__ import annotations

import dataclasses
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))


def main(argv) -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    if not torch.cuda.is_available():
        print("torch_moe_dispatch_profile: no CUDA device", file=sys.stderr)
        return 1
    t, d, e, k = (int(x) for x in argv) if argv else (8192, 2048, 60, 4)
    cfg = get_config("qwen2-moe-a2.7b")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, n_experts=e, top_k=k))
    cap = moe._capacity(t, cfg)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    print(f"T={t} D={d} E={e} k={k} capacity={cap}")
    g = torch.Generator(device="cuda").manual_seed(0)
    xt = torch.randn(t, d, device="cuda", generator=g).bfloat16()
    probs = torch.softmax(torch.randn(t, e, device="cuda", generator=g), -1)
    top_p, top_e = torch.topk(probs, k)
    for _ in range(2):
        moe._dispatch(xt, top_p, top_e, e, cap)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        moe._dispatch(xt, top_p, top_e, e, cap)
        torch.cuda.synchronize()
    rows = prof.key_averages()
    kernels = sorted((r for r in rows if r.device_type == DeviceType.CUDA),
                     key=lambda r: -r.self_device_time_total)
    for r in kernels[:12]:
        print(f"kernel {r.self_device_time_total / 1e3:9.3f} ms x{r.count}"
              f"  {r.key[:100]}")
    ops = sorted((r for r in rows if r.device_type == DeviceType.CPU
                  and r.key.startswith("aten::")),
                 key=lambda r: -r.device_time_total)
    for r in ops[:12]:
        print(f"op {r.device_time_total / 1e3:9.3f} ms x{r.count}  {r.key}")
    onehot = torch.nn.functional.one_hot(top_e.reshape(-1), e)
    onehot_t = onehot.T.contiguous()
    for name, fn in (("outer (T*k, E), dim 0", lambda: onehot.cumsum(0)),
                     ("inner (E, T*k), dim 1", lambda: onehot_t.cumsum(1))):
        fn()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(20):
            fn()
        end.record()
        end.synchronize()
        print(f"scan {name}: {start.elapsed_time(end) / 20:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
