"""Cells, configurations, drivers and per-layer metrics, each found by its
file name under ``benchmark/``: a later cell, mix or metric is a new file,
never an edit of one that is there."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

BENCH = Path(__file__).resolve().parents[1]
PEAK_BF16 = 989e12     # FLOP/s: H100 SXM data sheet, bf16 dense
PEAK_HBM = 3.35e12     # B/s: H100 SXM data sheet, HBM3


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def workload(name: str) -> Dict:
    """``workloads/<name>.json`` with its configuration merged in under
    ``"model"``."""
    path = BENCH / "workloads" / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"no cell {name!r}: {path} is missing")
    cell = load_json(path)
    cell["name"] = name
    cell["model"] = load_json(BENCH / "configs" / f"{cell['config']}.json")
    return cell


def _module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str) -> ModuleType:
    return _module(BENCH / "drivers" / f"{name}.py", f"bench_driver_{name}")


def metric_modules() -> List[ModuleType]:
    """Every per-layer metric reader, by file name (``metrics/<name>.py``:
    the metric's name is the file's name without ``.py``)."""
    mods = []
    for path in sorted((BENCH / "metrics").glob("*.py")):
        if path.name.startswith("_"):
            continue
        mod = _module(path, "bench_metric_" + path.stem.replace(".", "_"))
        mod.NAME = path.stem
        mods.append(mod)
    return mods


def var_config(model: Dict):
    """The port's ``VARConfig`` for a configuration file."""
    from sdvar_tpu_torch.config import VARConfig

    v = model["var"]
    return VARConfig(depth=v["depth"], patch_nums=tuple(v["patch_nums"]),
                     vocab_size=v["vocab_size"], Cvae=v["Cvae"],
                     num_classes=v["num_classes"], mlp_ratio=v["mlp_ratio"],
                     norm_eps=v["norm_eps"], shared_aln=v["shared_aln"],
                     attn_l2_norm=v["attn_l2_norm"],
                     cond_drop_rate=v["cond_drop_rate"],
                     drop_rate=v["drop_rate"],
                     drop_path_rate=v["drop_path_rate"],
                     head_dim=v["head_dim"])


def vqvae_config(model: Dict):
    """The port's ``VQVAEConfig`` for a configuration file."""
    from sdvar_tpu_torch.config import VQVAEConfig

    q = model["vqvae"]
    return VQVAEConfig(vocab_size=q["vocab_size"], z_channels=q["z_channels"],
                       ch=q["ch"], ch_mult=tuple(q["ch_mult"]),
                       num_res_blocks=q["num_res_blocks"],
                       quant_resi=q["quant_resi"],
                       share_quant_resi=q["share_quant_resi"],
                       patch_nums=tuple(model["var"]["patch_nums"]),
                       using_sa=q["using_sa"], using_mid_sa=q["using_mid_sa"])
