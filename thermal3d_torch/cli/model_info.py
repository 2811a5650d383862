"""Model / checkpoint introspection — `python -m thermal3d_torch.cli.model_info`
(counterpart of thermal3d/cli/model_info.py, scripts/model_info.py).

Parameter counts and groups (encoder / decoder / head / other), the
architecture reconstructed from the key layout, its text summary, a box
diagram of it (--diagram), and a validator that diffs a checkpoint against
the released-checkpoint inventory of a config (--validate,
convert/from_pth.py::released_checkpoint_keys). Runs on the host.
"""

from __future__ import annotations

import argparse
import re
from collections import OrderedDict
from typing import Dict

import numpy as np


def param_stats(state: Dict) -> Dict:
    """Count and group the parameters of a state dict by key."""
    groups = {"encoder": 0, "decoder": 0, "head": 0, "other": 0}
    layer_types: Dict[str, int] = {}
    total = 0
    for key, value in state.items():
        n = int(np.prod(value.shape)) if len(value.shape) else 1
        total += n
        kl = key.lower()
        if "enc" in kl or "patch_embed" in kl:
            groups["encoder"] += n
        elif "dec" in kl:
            groups["decoder"] += n
        elif "head" in kl:
            groups["head"] += n
        else:
            groups["other"] += n
        leaf = key.split(".")[-1]
        layer_types[leaf] = layer_types.get(leaf, 0) + n
    return {"total": total, "groups": groups, "layer_types": layer_types, "n_tensors": len(state)}


def reconstruct_architecture(state: Dict[str, np.ndarray]) -> Dict:
    """Block counts, widths and heads from a state dict's key layout; the
    stacked `enc_scan.` / `dec_scan.` keys of a scan-layout tree are read
    as their unstacked blocks."""
    if any(k.startswith(("enc_scan.", "dec_scan.")) for k in state):
        state = dict(state)
        for prefix, target in (("enc_scan.blk.", "enc_blocks"), ("dec_scan.blk1.", "dec_blocks"),
                               ("dec_scan.blk2.", "dec_blocks2")):
            for k in [k for k in state if k.startswith(prefix)]:
                v = state.pop(k)
                rest = k[len(prefix):]
                for i in range(v.shape[0]):
                    state[f"{target}.{i}.{rest}"] = v[i]
    arch: Dict = OrderedDict()
    for comp in ("patch_embed", "enc_blocks", "dec_blocks", "dec_blocks2"):
        pat = re.compile(rf"{comp}\.(\d+)\.")
        block_ids = {int(m.group(1)) for m in map(pat.match, state) if m}
        if block_ids or any(k.startswith(comp) for k in state):
            arch[comp] = {"n_blocks": len(block_ids)}
    if "patch_embed.proj.weight" in state:
        w = state["patch_embed.proj.weight"]
        arch["patch_embed"].update(embed_dim=int(w.shape[0]), patch_size=int(w.shape[2]))
    for comp in ("enc_blocks", "dec_blocks"):
        qkv = f"{comp}.0.attn.qkv.weight"
        if qkv in state:
            dim = int(state[qkv].shape[1])
            arch[comp]["embed_dim"] = dim
            # the head count is in no shape: the dim/64 convention
            arch[comp]["num_heads_dim64"] = dim // 64
        if any("cross_attn" in k and comp in k for k in state):
            arch[comp]["attention"] = "Self + Cross Attention"
    arch["heads"] = sorted({k.split(".")[0] for k in state if "head" in k.split(".")[0]})
    return arch


def render_architecture_text(arch: Dict) -> str:
    """The reference's summary layout (scripts/model_info.py:262-324):
    Encoder / Decoder / Output Heads."""
    lines = ["DUSt3R Model Architecture", "===============================", "", "Encoder:"]
    pe = arch.get("patch_embed", {})
    if pe:
        ps, ed = pe.get("patch_size", "?"), pe.get("embed_dim", "?")
        lines.append(f"  Patch Embedding: {ps}x{ps} patches -> {ed} dim")
    eb = arch.get("enc_blocks", {})
    if eb:
        lines.append(f"  Transformer Encoder: {eb.get('n_blocks', '?')} blocks "
                     f"with {eb.get('embed_dim', '?')} dim")
        lines.append(f"  Attention Type: {eb.get('attention', 'Self Attention')}")
    lines += ["", "Decoder:"]
    db = arch.get("dec_blocks", {})
    if db:
        lines.append("  Decoder Embedding: Maps encoder features to decoder space")
        lines.append(f"  Transformer Decoder: {db.get('n_blocks', '?')} blocks "
                     f"with {db.get('embed_dim', '?')} dim")
        lines.append(f"  Attention Type: {db.get('attention', 'Self Attention')}")
    if arch.get("dec_blocks2"):
        lines.append(f"  Second Decoder Branch: {arch['dec_blocks2'].get('n_blocks', '?')} blocks")
        lines.append("  Dual-branch decoder structure (for processing two views)")
    lines += ["", "Output Heads:"]
    for h in arch.get("heads", []):
        lines.append(f"  {h}: Converts features to final outputs")
    return "\n".join(lines)


DIAGRAM_SCALE = 100  # pixels a unit of the reference's 11 × 5 drawing


def draw_architecture_diagram(arch: Dict, save_path: str) -> None:
    """The reference's box diagram (thermal3d/cli/model_info.py:
    draw_architecture_diagram) as a PNG through viz/png.py: the same boxes,
    colours and arrows on its 11 × 5 layout (patch embed → encoder, shared
    by both views → the two decoder branches with their cross-attention
    exchange → the heads). Its labels are the text render_architecture_text
    prints; they are not drawn (ROADMAP: figure text and frame)."""
    from thermal3d_torch.viz.draw import arrow, hex_color, round_rect
    from thermal3d_torch.viz.png import write_png

    s = DIAGRAM_SCALE
    img = np.full((5 * s, 11 * s, 3), 255, np.uint8)
    ink = hex_color("#333333")

    def px(x, y):  # drawing units (y up) → pixels (y down)
        return x * s, (5 - y) * s

    def box(x, y, w, h, color):
        pad = 0.06  # boxstyle round,pad=0.06
        x0, y0 = px(x - pad, y + h + pad)
        x1, y1 = px(x + w + pad, y - pad)
        round_rect(img, x0, y0, x1, y1, pad * s, hex_color(color), ink, width=1.2 * s / 72)

    def link(x0, y0, x1, y1):
        arrow(img, px(x0, y0), px(x1, y1), ink, width=1.1 * s / 72, head=0.14 * s)

    box(0.3, 2.0, 1.6, 1.0, "#cfe3f7")  # patch embed
    link(1.9, 2.5, 2.5, 2.5)
    box(2.5, 2.0, 2.0, 1.0, "#cfe3f7")  # encoder
    link(4.5, 2.5, 5.2, 3.6)
    link(4.5, 2.5, 5.2, 1.4)
    box(5.2, 3.2, 2.4, 1.0, "#d9efd3")  # decoder, view 1
    box(5.2, 0.9, 2.4, 1.0, "#d9efd3")  # decoder 2, view 2
    link(6.4, 3.2, 6.4, 1.9)  # the cross-attention exchange
    link(6.8, 1.9, 6.8, 3.2)
    heads = arch.get("heads", []) or ["downstream_head1", "downstream_head2"]
    for _, y in zip(heads, (3.7, 1.4) if len(heads) >= 2 else (2.5,)):
        link(7.6, y, 8.3, y)
        box(8.3, y - 0.5, 2.3, 1.0, "#f7e3cf")
    write_png(save_path, img)


def validate_against_config(state: Dict[str, np.ndarray], config, released: bool = True) -> Dict:
    """Diff a state dict against the key and shape inventory: with released,
    a released checkpoint's (released_checkpoint_keys at the checkpoint's
    own decoder depth, read from its keys), else the model's
    (expected_torch_keys). `mask_token` may be missing (re-saved fine-tunes
    drop it; the model never reads it)."""
    from thermal3d_torch.convert.from_pth import expected_torch_keys, released_checkpoint_keys

    if released:
        dec_idx = [int(k.split(".")[1]) for k in state
                   if k.startswith(("dec_blocks.", "dec_blocks2."))]
        ckpt_depth = max(dec_idx) + 1 if dec_idx else config.dec_depth
        expected = released_checkpoint_keys(config,
                                            ckpt_dec_depth=max(ckpt_depth, config.dec_depth))
    else:
        expected = expected_torch_keys(config)
    missing = sorted(set(expected) - set(state) - {"mask_token"})
    unexpected = sorted(set(state) - set(expected))
    shape_mismatches = {
        k: (tuple(np.asarray(state[k]).shape), expected[k])
        for k in set(expected) & set(state)
        if tuple(np.asarray(state[k]).shape) != expected[k]
    }
    return {"missing": missing, "unexpected": unexpected, "shape_mismatches": shape_mismatches}


def main(argv=None):
    parser = argparse.ArgumentParser(description="Inspect a DUSt3R checkpoint")
    parser.add_argument("--checkpoint", type=str, required=True, help=".pth file")
    parser.add_argument("--validate", action="store_true",
                        help="diff against the released-checkpoint key spec of --config")
    parser.add_argument("--config", type=str, default="dustr224",
                        choices=["dustr224", "mastr512"])
    parser.add_argument("--diagram", type=str, default=None, metavar="PNG",
                        help="draw the reconstructed architecture as a box diagram to "
                             "this file")
    args = parser.parse_args(argv)

    from thermal3d_torch.convert.from_pth import load_torch_checkpoint
    from thermal3d_torch.core.config import DUSTR_224_LINEAR, MASTR_512_CATMLPDPT

    state = {k: np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach") else v)
             for k, v in load_torch_checkpoint(args.checkpoint).items()}
    stats = param_stats(state)
    print(f"Total parameters: {stats['total']:,} in {stats['n_tensors']} tensors")
    for g, n in stats["groups"].items():
        print(f"  {g:<8}: {n:,} ({100 * n / max(stats['total'], 1):.1f}%)")
    arch = reconstruct_architecture(state)
    print()
    print(render_architecture_text(arch))
    print("\nArchitecture (raw):")
    for comp, info in arch.items():
        print(f"  {comp}: {info}")
    if args.diagram:
        draw_architecture_diagram(arch, args.diagram)
        print(f"\nDiagram saved to {args.diagram}")
    if args.validate:
        cfg = DUSTR_224_LINEAR if args.config == "dustr224" else MASTR_512_CATMLPDPT
        report = validate_against_config(state, cfg)
        print(f"\nValidation: {len(report['missing'])} missing, "
              f"{len(report['unexpected'])} unexpected, "
              f"{len(report['shape_mismatches'])} shape mismatches")
        return report
    return stats


if __name__ == "__main__":
    main()
