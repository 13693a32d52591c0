"""Config system: attribute-access dicts loaded from YAML files.

Counterpart of ``mixermdm_tpu/config.py``: :class:`Config`, the yacs-style
scalar coercion, the ``*_DEFAULT`` architecture dicts and
:func:`tiny_config`, copied so the port needs nothing of the JAX package.

The port has no YAML dependency: :func:`load_yaml` reads the subset of YAML
the configs under ``configs/`` use (nested block mappings of scalars,
comments, quoted or bare strings) and resolves scalars the way
``yaml.safe_load`` does before the yacs-style ``literal_eval`` coercion.
"""

from __future__ import annotations

import ast
import re
from typing import Any


class Config(dict):
    """dict with attribute access; nested dicts are wrapped recursively."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    @classmethod
    def wrap(cls, obj):
        if isinstance(obj, dict):
            return cls({k: cls.wrap(v) for k, v in obj.items()})
        if isinstance(obj, list):
            return [cls.wrap(v) for v in obj]
        return obj


def _coerce_scalar(v: Any) -> Any:
    """yacs-style decoding of string scalars: ``literal_eval`` where it gives
    a non-string (so ``None`` and ``1e-5`` become values), else the string."""
    if not isinstance(v, str):
        return v
    try:
        out = ast.literal_eval(v)
    except (ValueError, SyntaxError):
        return v
    return v if isinstance(out, str) else out


def _coerce_tree(obj: Any) -> Any:
    if isinstance(obj, dict):
        return {k: _coerce_tree(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_coerce_tree(v) for v in obj]
    return _coerce_scalar(obj)


# YAML 1.1 implicit scalar types, as PyYAML's SafeLoader resolves them.
_BOOL = {"yes": True, "no": False, "true": True, "false": False, "on": True, "off": False}
_NULL = {"", "~", "null", "Null", "NULL"}
_INT = re.compile(r"^[-+]?(0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"^[-+]?(?:[0-9][0-9_]*)?\.[0-9_]*(?:[eE][-+][0-9]+)?$")


def _scalar(text: str) -> Any:
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        body = text[1:-1]
        return body.replace("''", "'") if text[0] == "'" else ast.literal_eval(text)
    if text in _NULL:
        return None
    if text.lower() in _BOOL and text in (text.lower(), text.capitalize(), text.upper()):
        return _BOOL[text.lower()]
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text) and text not in (".", "-.", "+."):
        return float(text.replace("_", ""))
    return text


def _strip_comment(line: str) -> str:
    """Drop a ``#`` comment that is not inside quotes."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def parse_yaml(text: str) -> dict:
    """Parse block mappings of scalars (the subset ``configs/`` uses)."""
    root: dict = {}
    stack = [(-1, root)]   # (indent, mapping)
    pending = None         # (indent, parent, key) of a "key:" with no value yet
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = _strip_comment(raw).rstrip()
        if not line.strip() or line.strip() in ("---", "..."):
            continue
        indent = len(line) - len(line.lstrip(" "))
        body = line.strip()
        if body.startswith("- ") or body == "-" or body[0] in "[{&*!|>":
            raise ValueError(f"line {lineno}: YAML construct not supported here: {body!r}")
        if pending is not None:
            p_indent, p_parent, p_key = pending
            pending = None
            if indent > p_indent:
                child: dict = {}
                p_parent[p_key] = child
                stack.append((p_indent, child))
            else:
                p_parent[p_key] = None
        while stack and indent <= stack[-1][0]:
            stack.pop()
        if not stack:
            raise ValueError(f"line {lineno}: bad indentation")
        parent = stack[-1][1]
        key, sep, value = body.partition(":")
        if not sep or (value and value[0] not in " \t"):
            raise ValueError(f"line {lineno}: expected 'key: value', got {body!r}")
        key = key.strip()
        if len(key) >= 2 and key[0] == key[-1] and key[0] in "'\"":
            key = key[1:-1]
        value = value.strip()
        if value:
            parent[key] = _scalar(value)
        else:
            pending = (indent, parent, key)
            parent[key] = None
    return root


def load_yaml(path: str) -> Config:
    """Load a model config file."""
    with open(path) as f:
        return Config.wrap(_coerce_tree(parse_yaml(f.read())))


# ---------------------------------------------------------------------------
# Default architecture configs mirroring configs/models/{MixerMDM,in2IN,
# individual}.yaml and the JAX package's MDM / InterGen defaults, so the
# package works without any files on disk.
# ---------------------------------------------------------------------------

IN2IN_INTERACTION_DEFAULT = Config.wrap(
    {
        "NAME": "in2IN",
        "NUM_LAYERS": 8, "NUM_HEADS": 8, "DROPOUT": 0.1,
        "INPUT_DIM": 262, "LATENT_DIM": 1024, "FF_SIZE": 2048,
        "ACTIVATION": "gelu", "CHECKPOINT": "checkpoints/in2IN.ckpt",
        "DIFFUSION_STEPS": 1000, "BETA_SCHEDULER": "cosine", "SAMPLER": "uniform",
        "MOTION_REP": "global", "T_BAR": 700, "STRATEGY": "ddim50",
        "CFG_WEIGHT": 3, "CFG_WEIGHT_INTERACTION": 3, "CFG_WEIGHT_INDIVIDUAL": 1,
    }
)

IN2IN_INDIVIDUAL_DEFAULT = Config.wrap(
    {
        "NAME": "in2INind",
        "NUM_LAYERS": 8, "NUM_HEADS": 8, "DROPOUT": 0.1,
        "INPUT_DIM": 262, "LATENT_DIM": 1024, "FF_SIZE": 2048,
        "ACTIVATION": "gelu", "CHECKPOINT": "checkpoints/individual.ckpt",
        "DIFFUSION_STEPS": 1000, "BETA_SCHEDULER": "cosine", "SAMPLER": "uniform",
        "MOTION_REP": "global", "T_BAR": 700, "STRATEGY": "ddim50",
        "CFG_WEIGHT": 3.5,
    }
)

MIXERMDM_DEFAULT = Config.wrap(
    {
        "NAME": "MixerMDM",
        "GENERATOR": {
            "NUM_LAYERS": 4, "NUM_HEADS": 8, "DROPOUT": 0.1,
            "INPUT_DIM": 262, "LATENT_DIM": 512, "FF_SIZE": 1024,
        },
        "DISCRIMINATOR": {
            "NUM_LAYERS": 2, "NUM_HEADS": 4, "DROPOUT": 0.1,
            "INPUT_DIM": 262, "LATENT_DIM": 256, "FF_SIZE": 512,
        },
        "ACTIVATION": "gelu",
        "CHECKPOINT": "checkpoints/MixerMDM.ckpt",
        "DIFFUSION_STEPS": 1000, "BETA_SCHEDULER": "cosine", "SAMPLER": "uniform",
        "MOTION_REP": "global", "T_BAR": 700, "STRATEGY": "ddim50",
        "CFG_WEIGHT": 3.5, "MIXING_MODE": 4, "FORCE_INFLUENCE_VAL": None,
        # W8A8 int8 projections for the frozen denoisers at sampling time, as
        # in the JAX package's default (systems/mixermdm.py).
        "QUANT_FROZEN": True,
    }
)

# The base-model baselines (the JAX package's MDM_DEFAULT / INTERGEN_DEFAULT):
# MDM, single person, on the ViT-B/32 tower; InterGen, two persons.
MDM_DEFAULT = Config.wrap(
    {
        "NAME": "MDM",
        "NUM_LAYERS": 8, "NUM_HEADS": 4, "DROPOUT": 0.1,
        "INPUT_DIM": 262, "LATENT_DIM": 512, "FF_SIZE": 1024,
        "ACTIVATION": "gelu", "CHECKPOINT": "checkpoints/mdm.ckpt",
        "DIFFUSION_STEPS": 1000, "BETA_SCHEDULER": "cosine", "SAMPLER": "uniform",
        "MOTION_REP": "global", "T_BAR": 700, "STRATEGY": "ddim50",
        "CFG_WEIGHT": 2.5,
    }
)

INTERGEN_DEFAULT = Config.wrap(
    {
        "NAME": "InterGen",
        "NUM_LAYERS": 8, "NUM_HEADS": 8, "DROPOUT": 0.1,
        "INPUT_DIM": 262, "LATENT_DIM": 1024, "FF_SIZE": 2048,
        "ACTIVATION": "gelu", "CHECKPOINT": "checkpoints/intergen.ckpt",
        "DIFFUSION_STEPS": 1000, "BETA_SCHEDULER": "cosine", "SAMPLER": "uniform",
        "MOTION_REP": "global", "T_BAR": 700, "STRATEGY": "ddim50",
        "CFG_WEIGHT": 3.5,
    }
)

# Adversarial training defaults mirroring configs/train/MixerMDM.yaml.
MIXERMDM_TRAIN_DEFAULT = Config.wrap(
    {
        "GENERAL": {"EXP_NAME": "mixermdm-tpu", "CHECKPOINT": "./checkpoints", "LOG_DIR": "./log"},
        "TRAIN": {
            "LR": 1e-5, "WEIGHT_DECAY": 1e-4, "BATCH_SIZE": 64, "EPOCH": 300,
            "LOG_STEPS": 25, "SAVE_EPOCH": 25, "NUM_WORKERS": 4,
            "INDIVIDUAL_LOSS_FACTOR": 1, "INTERACTION_LOSS_FACTOR": 2,
            "DISCRIMINATOR_STEPS": 1, "GRAD_ACC_STEPS": 2, "LOSS_L1": 0.1,
        },
    }
)


def tiny_config(latent: int = 64, layers: int = 2, heads: int = 4,
                diffusion_steps: int = 20) -> Config:
    """Miniature config for tests / CPU smoke runs."""
    return Config.wrap(
        {
            "NAME": "in2IN",
            "NUM_LAYERS": layers, "NUM_HEADS": heads, "DROPOUT": 0.0,
            "INPUT_DIM": 262, "LATENT_DIM": latent, "FF_SIZE": latent * 2,
            "ACTIVATION": "gelu",
            "DIFFUSION_STEPS": diffusion_steps, "BETA_SCHEDULER": "cosine",
            "SAMPLER": "uniform", "MOTION_REP": "global", "T_BAR": diffusion_steps // 2,
            "STRATEGY": f"ddim{max(2, diffusion_steps // 4)}",
            "CFG_WEIGHT": 3.5, "CFG_WEIGHT_INTERACTION": 3, "CFG_WEIGHT_INDIVIDUAL": 1,
        }
    )
