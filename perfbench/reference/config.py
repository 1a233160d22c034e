"""A configuration file of the benchmark as the reference reads it.

The file holds the published configuration (``published``: the scene's
YAML groups, or the object's ``key = value`` pairs), the keys the run
adds or changes (``added``, merged over it), and the dataset's shapes
(``dataset``).  ``arch`` and ``hyper`` read the merged document with the
published defaults for the keys it leaves out.
"""

from __future__ import annotations

import copy
import math


def merged(config: dict) -> dict:
    """``published`` with ``added`` merged over it, group by group."""
    doc = copy.deepcopy(config["published"])
    for k, v in config.get("added", {}).items():
        if isinstance(v, dict):
            doc.setdefault(k, {}).update(v)
        else:
            doc[k] = v
    return doc


def _num(v):
    """A number, or a product such as ``"32*16"`` as the YAML writes it."""
    if isinstance(v, str):
        return math.prod(float(p) for p in v.split("*"))
    return v


def arch(config: dict) -> dict:
    doc, ds = merged(config), config["dataset"]
    if config["format"] == "scene_yaml":
        model, render = doc["model"], doc["render"]
        return {
            "depth": int(model["netdepth"]), "width": int(model["netwidth"]), "skips": (4,),
            "n_freqs_pos": int(render["multires"]), "n_freqs_dir": int(render["multires_views"]),
            "pos_scale": float(doc["pos_scalar_factor"]),
            "classes": int(ds["semantic_classes"]),
            "n_coarse": int(render["N_samples"]), "n_importance": int(render["N_importance"]),
            "perturb": float(render["perturb"]), "raw_noise_std": float(render["raw_noise_std"]),
            "white_bkgd": bool(render["white_bkgd"]),
        }
    return {
        "depth": int(doc["netdepth"]), "width": int(doc["netwidth"]), "skips": (4,),
        "n_freqs_pos": int(doc["multires"]), "n_freqs_dir": int(doc["multires_views"]),
        "pos_scale": 1.0, "classes": 0,
        "n_coarse": int(doc["N_samples"]), "n_importance": int(doc["N_importance"]),
        "perturb": float(doc["perturb"]), "raw_noise_std": float(doc["raw_noise_std"]),
        "white_bkgd": bool(doc["white_bkgd"]),
    }


def hyper(config: dict) -> dict:
    doc, ds = merged(config), config["dataset"]
    common = {"h": ds["height"], "w": ds["width"], "near": ds["near"], "far": ds["far"],
              "residual_switch": 100_000, "intensity_switch": 50_000}
    if config["format"] == "scene_yaml":
        t, r = doc["train"], doc["render"]
        return {**common, "sampler": "pool", "pair_mode": "label",
                "n_rays": int(_num(r["N_rays"])), "lrate": float(t["lrate"]),
                "lrate_decay": float(t["lrate_decay"]), "wgt_sem": float(t["wgt_sem"]),
                "w_chroma": float(t["w_chroma"]), "w_n": float(t["w_n"]), "w_f": float(t["w_f"]),
                "w_s": float(t["w_s"]), "w_i1": float(t["w_i1"]), "w_i2": float(t["w_i2"]),
                "w_res1": float(t["w_res1"]), "w_res2": float(t["w_res2"]),
                "no_intrinsic_loss": bool(t["no_intrinsic_loss"]),
                "no_cluster": bool(t["no_cluster"]), "n_iters": int(t["N_iters"]),
                "vis_every": int(_num(doc["logging"]["step_vis_train"])), "b_f_cap": 1.0}
    return {**common, "sampler": "pose", "pair_mode": "mask", "n_rays": int(doc["N_rand"]),
            "lrate": float(doc["lrate"]), "lrate_decay": float(doc["lrate_decay"]) * 1000.0,
            "wgt_sem": 0.0, "w_chroma": float(doc["w_chroma"]), "w_n": float(doc["w_r"]),
            "w_f": float(doc["w_f"]), "w_s": float(doc["w_s"]), "w_i1": float(doc["w_i1"]),
            "w_i2": float(doc["w_i2"]), "w_res1": float(doc["w_res1"]),
            "w_res2": float(doc["w_res2"]), "no_intrinsic_loss": False,
            "no_cluster": bool(doc["no_cluster"]), "n_iters": int(doc["N_iters"]),
            "vis_every": int(doc["i_testset"]), "b_f_cap": 0.5,
            "precrop_iters": int(doc["precrop_iters"]), "precrop_frac": float(doc["precrop_frac"])}


def cluster_anneal(hp: dict, step: int):
    """The published anneal at a rebuild of ``step``: the cluster term's
    weight ``min(0.1^(2 - 2n), 1)`` and the band factor ``min(0.5^(2 -
    2n), cap)``, with ``n = (step - every) / (N - 2 every)``."""
    denom = float(hp["n_iters"] - 2 * hp["vis_every"])
    n = (step - hp["vis_every"]) / denom if denom else 1.0
    return min(0.1 ** (2.0 - 2.0 * n), 1.0), min(0.5 ** (2.0 - 2.0 * n), hp["b_f_cap"])
