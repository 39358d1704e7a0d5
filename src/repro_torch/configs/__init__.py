"""Architecture registry: the 10 assigned archs (+ paper-native CNNs).

Usage:  cfg = get_config("zamba2-1.2b");  red = get_config("zamba2-1.2b",
reduced=True). The config files are the JAX package's, as pure data; `shapes` holds the
dry run's input-shape cells.
"""

from __future__ import annotations

import importlib

from .shapes import SHAPES, ShapeCell, cell_applicable, input_specs, \
    enc_len_for

_ARCH_MODULES = {
    "pixtral-12b": "pixtral_12b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "internlm2-20b": "internlm2_20b",
    "smollm-135m": "smollm_135m",
    "minicpm-2b": "minicpm_2b",
    "qwen1.5-110b": "qwen15_110b",
    "zamba2-1.2b": "zamba2_1p2b",
    "rwkv6-1.6b": "rwkv6_1p6b",
    "arctic-480b": "arctic_480b",
    "mixtral-8x22b": "mixtral_8x22b",
}

ARCH_IDS = list(_ARCH_MODULES)

# the paper's own CNN targets (graphs for the predictable-inference pipeline)
PAPER_CNNS = ("resnet50", "yolov5s", "small_cnn")


def get_config(arch_id: str, reduced: bool = False):
    mod = importlib.import_module(
        f".{_ARCH_MODULES[arch_id]}", __package__)
    return mod.REDUCED if reduced else mod.CONFIG


def get_cnn_graph(name: str, **kw):
    from ..core import cnn
    if name == "resnet50":
        return cnn.resnet50(**kw)
    if name == "yolov5s":
        return cnn.yolov5s_backbone(**kw)
    if name == "small_cnn":
        return cnn.small_cnn(**kw)
    raise KeyError(name)


__all__ = ["ARCH_IDS", "PAPER_CNNS", "get_config", "get_cnn_graph",
           "SHAPES", "ShapeCell", "cell_applicable", "input_specs",
           "enc_len_for"]
