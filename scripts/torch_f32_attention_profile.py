"""Device time of the float32 attention calls by kernel, on the card.

For each float32 head_dim-64 shape of chip_smoke.py's phase 3, one call of
the port's 3xTF32 kernel (the prologue that splits K and V, then the
key-tile kernel) and one call of PyTorch's scaled_dot_product_attention on
the same operands, each under torch.profiler after a warm-up: every device
kernel's name and microseconds. SDPA is a yardstick the port never calls;
its kernel name says which of PyTorch's attention kernels serves float32.
Prints one JSON line a shape, then the card's name and power limit.

    python3 scripts/torch_f32_attention_profile.py

Needs a CUDA card; exits 1 without one.
"""

from __future__ import annotations

import importlib
import json
import math
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

# (kernel, B, S or (Sq, Sk), C or H, heads): K2 packed [B,S,3C], K4 [B,H,S,64]
SHAPES = (("K2", 32, 196, 1024, 16), ("K2", 8, 1024, 1024, 16),
          ("K4", 8, (1024, 1024), 16, 16), ("K4", 32, (196, 196), 16, 16))


def profile(torch, fn) -> dict:
    """Microseconds of each device kernel over one call of fn (warmed up)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as run_profile

    fn()
    torch.cuda.synchronize()
    with run_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us = e.time_range.end - e.time_range.start
            kernels[e.name] = kernels.get(e.name, 0.0) + us
    return kernels


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("torch_f32_attention_profile: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    fa = importlib.import_module("thermal3d_torch.kernels.flash_attention")
    from thermal3d_torch.models.rope import make_grid_positions, rope_tables

    for kind, b, s, c, heads in SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(b)
        if kind == "K2":
            side = int(math.isqrt(s))
            cos, sin = rope_tables(make_grid_positions(side, side, device="cuda"), 64)
            qkv = torch.randn((b, s, 3 * c), generator=gen, device="cuda")
            q, k, v = (qkv[..., i * c:(i + 1) * c].reshape(b, s, heads, 64).transpose(1, 2)
                       for i in range(3))

            def port():
                return fa.fused_rope_attention(qkv, cos, sin, heads, 0.125)
            label = f"K2 [{b},{s},{3 * c}] H{heads}"
        else:
            sq, sk = s
            q = torch.randn((b, sq, heads, 64), generator=gen, device="cuda").transpose(1, 2)
            k, v = (torch.randn((b, sk, heads, 64), generator=gen, device="cuda").transpose(1, 2)
                    for _ in range(2))

            def port():
                return fa.flash_attention_pallas(q, k, v, 0.125)
            label = f"K4 [{b},{heads},{sq},64] Sk={sk}"
        ours = profile(torch, port)
        sdpa = profile(torch, lambda: F.scaled_dot_product_attention(q, k, v, scale=0.125))
        print(json.dumps({"case": label, "port_us": ours, "port_total_us": sum(ours.values()),
                          "sdpa_us": sdpa, "sdpa_total_us": sum(sdpa.values())}), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
