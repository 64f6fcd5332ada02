"""Architecture registry: ``get_config(name)`` / ``list_archs()``.

Lists only the archs the port runs so far: the dense GQA decoders it
serves (yi-6b, minitron-8b, qwen3-32b) and trains (those and gemma2-2b,
whose local/global layers the paged server refuses, as the reference's
does), the routed-expert decoder olmoe-1b-7b, the patch-frontend VLM
pixtral-12b (served as a text decoder, as the reference serves it), and
the recurrent families xlstm-350m (mLSTM/sLSTM) and hymba-1.5b
(attention beside Mamba), the encoder-decoder whisper-medium and
deepseek-v2-236b (MLA attention, a dense first layer before routed and
shared experts), which train and decode through ``models.model`` but are
not served by the paged engine.  That is every arch of the reference's
registry.
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.configs.base import ArchConfig, SHAPES, ShapeSpec

#: in the reference registry's order
_MODULES = {
    "xlstm-350m": "repro_torch.configs.xlstm_350m",
    "pixtral-12b": "repro_torch.configs.pixtral_12b",
    "gemma2-2b": "repro_torch.configs.gemma2_2b",
    "yi-6b": "repro_torch.configs.yi_6b",
    "minitron-8b": "repro_torch.configs.minitron_8b",
    "qwen3-32b": "repro_torch.configs.qwen3_32b",
    "hymba-1.5b": "repro_torch.configs.hymba_1p5b",
    "deepseek-v2-236b": "repro_torch.configs.deepseek_v2_236b",
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
    "whisper-medium": "repro_torch.configs.whisper_medium",
}


def list_archs() -> List[str]:
    return list(_MODULES)


def get_config(name: str) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {list_archs()}")
    return importlib.import_module(_MODULES[name]).CONFIG


def get_shape(name: str) -> ShapeSpec:
    return SHAPES[name]


def all_cells():
    """Every (arch, shape) cell with its applicability verdict."""
    out = []
    for a in list_archs():
        cfg = get_config(a)
        for s in SHAPES.values():
            ok, why = cfg.shape_applicable(s)
            out.append((cfg, s, ok, why))
    return out
