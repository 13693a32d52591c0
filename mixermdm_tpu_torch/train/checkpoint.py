"""Released checkpoints into the port's systems; counterpart of
``mixermdm_tpu/train/checkpoint.py`` (``load_torch_state_dict``,
``convert_in2in_system``, ``merge_dualmdm_state_dicts``,
``convert_mixermdm_system``, ``convert_mdm_denoiser``) and of
``mixermdm_tpu/cli/convert.py --family mixermdm / in2in / dualmdm / mdm``
(the shape-checked merge and the list of leaves no file filled).

The reference releases a MixerMDM as three PyTorch files:

* ``MixerMDM.ckpt``: the mixer core (``mixing.``), both discriminators and
  the mixer's own post-encoder head (``clipTransEncoder.`` / ``clip_ln.``);
  the frozen submodels are dropped at save;
* the individual and the interaction in2IN checkpoints: the denoiser
  (``decoder.net_<mode>.``) and its head (``clipTransEncoder_<mode>.`` /
  ``clip_ln_<mode>.``).

Any of the three may hold a CLIP tower (``token_embedding``,
``clip_transformer.resblocks``, ...).  The port's system holds three text
pipelines, each with its own tower (``MixerMDMSystem.text_pipelines``), and
each file's tower goes where the JAX converters put it: the individual
file's into ``model1``, the interaction file's into ``model2``, the mixer
file's into the mixer's own ``text``.  A tower that no file holds keeps its
values and is listed as unfilled.

The base models: an in2IN file of either mode into an In2INSystem
(:func:`load_released_in2in`); for DualMDM the interaction file and the
individual file merged as the reference merges them; an MDM file (denoiser
under ``model.``, tower under ``clip_model.``, ``embed_text``) into an
MDMSystem (:func:`load_released_mdm`).

Train states (:func:`save_train_state`, :func:`restore_train_state`,
:func:`latest_train_state_path`; JAX ``train/checkpoint.py:43-94``) are
native ``torch.save`` files of a trainer's ``state_dict``: the trained
parameters, every optimizer's state, the step and the sampler history.

The JAX package's ``--checkpoint`` is an orbax directory, which the port
cannot read: a JAX-trained system reaches the port as torch-named files,
written by the JAX exporters (``export_mixermdm_system``,
``export_in2in_system``, ``export_mdm_system``).  The port writes the same
files with the ``released_*_state_dict`` functions of :mod:`..weights` and
:func:`save_released`.
"""

from __future__ import annotations

import glob
import os
import pickle
import re
import sys
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from ..weights import MDM_RENAMES, MIXER_RENAMES, in2in_renames, rename, \
    without_individual_cross_attention


# What a pickled numpy array needs beside tensors: ``torch.save`` of the JAX
# exporters' dicts of numpy arrays reads under ``weights_only`` with these.
_NUMPY_GLOBALS = [np.ndarray.__reduce__(np.zeros(0))[0], np.ndarray, np.dtype] + [
    type(np.dtype(c)) for c in "?" + np.typecodes["AllInteger"] + np.typecodes["AllFloat"]]


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A checkpoint file as a flat dict of CPU tensors: a Lightning
    checkpoint's ``state_dict`` unwrapped, and the reference's ``model.``
    prefix stripped (JAX ``load_torch_state_dict``).  The file is read with
    ``weights_only=True``, which admits tensors, numpy arrays and plain
    containers.  A file that pickles other objects beside them, as a
    Lightning ``.ckpt`` may (its hyper-parameters, loop state), is read in
    full, as the JAX package reads every file, and that is printed: a full
    read runs whatever code the file holds, so load only files you trust."""
    try:
        with torch.serialization.safe_globals(_NUMPY_GLOBALS):
            ckpt = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        print(f"{path}: pickles objects other than tensors and arrays; reading it in full "
              f"(weights_only=False), which runs any code the file holds", file=sys.stderr)
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
    out = {}
    for key, value in sd.items():
        if key.startswith("model."):
            key = key[len("model."):]
        out[key] = value.detach() if torch.is_tensor(value) else torch.from_numpy(
            np.ascontiguousarray(value))
    return out


def released_entries(ckpt: Optional[str] = None, ckpt_individual: Optional[str] = None,
                     ckpt_interaction: Optional[str] = None) -> Dict[str, tuple]:
    """``{module path: (file, tensor)}`` of the given released files, keys
    mapped onto a MixerMDMSystem (``MIXER_RENAMES``; ``in2in_renames`` under
    ``model1.`` / ``model2.``).  A key with no module path is an error.  The
    individual file's cross-attention, which the individual denoiser does
    not have, is left out (as ``weights.load_denoiser_params`` leaves it
    out)."""
    entries: Dict[str, tuple] = {}
    if ckpt is not None:
        for key, value in rename(load_torch_state_dict(ckpt), MIXER_RENAMES).items():
            entries[key] = (ckpt, value)
    for path, name, mode in ((ckpt_individual, "model1", "individual"),
                             (ckpt_interaction, "model2", "interaction")):
        if path is None:
            continue
        sd = load_torch_state_dict(path)
        if mode == "individual":
            sd = without_individual_cross_attention(sd, "decoder.net_individual.")
        for key, value in rename(sd, in2in_renames(mode)).items():
            entries[f"{name}.{key}"] = (path, value)
    return entries


def save_released(path: str, state_dict: Dict[str, torch.Tensor]) -> None:
    """Write ``state_dict`` as the reference's files are, a Lightning
    checkpoint: ``{"state_dict": {"model.<key>": tensor}}``.  The loaders
    strip that ``model.``."""
    torch.save({"state_dict": {f"model.{k}": v for k, v in state_dict.items()}}, path)


@torch.no_grad()
def _copy_checked(system: nn.Module, entries: Dict[str, tuple], strict: bool) -> List[str]:
    """Copy ``{parameter path: (file, tensor)}`` into ``system`` in place,
    every shape checked before anything is copied; returns the parameters no
    entry filled (``strict``: a ``ValueError`` instead)."""
    params = dict(system.named_parameters())
    for key, (path, value) in entries.items():
        if key not in params:
            raise KeyError(f"{path}: {key!r} is not a parameter of the system")
        if tuple(value.shape) != tuple(params[key].shape):
            raise ValueError(f"{path}: shape mismatch at {key}: checkpoint "
                             f"{tuple(value.shape)} vs model {tuple(params[key].shape)}")
    unfilled = sorted(set(params) - set(entries))
    if strict and unfilled:
        raise ValueError(f"strict: {len(unfilled)} parameters are in no checkpoint file "
                         f"(first 10): {', '.join(unfilled[:10])}")
    for key, (_, value) in entries.items():
        params[key].copy_(value)
    return unfilled


def load_released_mixermdm(system: nn.Module, ckpt: Optional[str] = None,
                           ckpt_individual: Optional[str] = None,
                           ckpt_interaction: Optional[str] = None,
                           strict: bool = False) -> List[str]:
    """Load the released files (``ckpt``: ``MixerMDM.ckpt``; the two in2IN
    checkpoints) into ``system``, a
    :class:`~mixermdm_tpu_torch.systems.mixermdm.MixerMDMSystem`.

    Every entry is checked against its parameter's shape first (a key that
    the system lacks is a ``KeyError``, a shape that differs a
    ``ValueError``), then copied in place into the parameter's dtype and
    device.  Returns the parameter paths that no file filled; with
    ``strict`` those raise a ``ValueError`` before anything is copied.
    The copy moves each weight's version, so the int8 weights of the W8A8
    blocks quantise again from the loaded values at their next call."""
    return _copy_checked(system, released_entries(ckpt, ckpt_individual, ckpt_interaction),
                         strict)


def _in2in_file_entries(path: str, mode: str, keep=None) -> Dict[str, tuple]:
    sd = load_torch_state_dict(path)
    if keep is not None:
        sd = {k: v for k, v in sd.items() if k.startswith(keep)}
    if mode != "interaction":
        sd = without_individual_cross_attention(sd, "decoder.net_individual.")
    return {k: (path, v) for k, v in rename(sd, in2in_renames(mode)).items()}


# The individual file's keys that DualMDM merges into the interaction file's
# (JAX merge_dualmdm_state_dicts, reference dualmdm.py:4-17).
DUAL_INDIVIDUAL_KEYS = ("decoder.net_individual", "clipTransEncoder_individual",
                        "clip_ln_individual")


def load_released_in2in(system: nn.Module, ckpt: Optional[str] = None,
                        ckpt_individual: Optional[str] = None,
                        strict: bool = False) -> List[str]:
    """Load a released in2IN file into an In2INSystem of its mode, as
    :func:`load_released_mixermdm` loads (shape-checked, in place, the
    unfilled parameters returned).  In dual mode ``ckpt`` is the interaction
    file and ``ckpt_individual`` the individual one, merged as the JAX
    package's ``merge_dualmdm_state_dicts`` merges them: everything of the
    interaction file, and the individual file's denoiser and head.  An
    individual denoiser's cross-attention, which it does not have but
    reference files carry, is left out."""
    mode = system.mode
    entries: Dict[str, tuple] = {}
    if ckpt is not None:
        entries.update(_in2in_file_entries(ckpt, mode))
    if ckpt_individual is not None:
        if mode != "dual":
            raise ValueError("--ckpt-individual is the second file of the dual mode")
        entries.update(_in2in_file_entries(ckpt_individual, mode, keep=DUAL_INDIVIDUAL_KEYS))
    return _copy_checked(system, entries, strict)


def load_released_mdm(system: nn.Module, ckpt: str, strict: bool = False) -> List[str]:
    """Load a released MDM file (the denoiser under ``model.``, the tower
    under ``clip_model.``, ``embed_text``; reference mdm.py:71-82) into an
    MDMSystem, as :func:`load_released_mixermdm` loads."""
    entries = {k: (ckpt, v) for k, v in rename(load_torch_state_dict(ckpt), MDM_RENAMES).items()}
    return _copy_checked(system, entries, strict)


# ---------------------------------------------------------------------------
# Train states (--resume)
# ---------------------------------------------------------------------------

def save_train_state(path: str, trainer) -> None:
    """Write ``trainer.state_dict()`` (a :class:`..train.trainer.MixerTrainer`
    or :class:`..train.trainer.BaseTrainer`) to ``path``, through a
    temporary file renamed into place, so an interrupted save leaves the
    previous file whole."""
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(trainer.state_dict(), tmp)
    os.replace(tmp, path)


def restore_train_state(path: str, trainer) -> None:
    """Load a file of :func:`save_train_state` into ``trainer`` (built as
    the one that saved it: the same system and options), every parameter,
    moment, counter and the sampler history copied in place.  The file is
    read with ``weights_only=True``."""
    trainer.load_state_dict(torch.load(path, map_location=trainer.system.device,
                                       weights_only=True))


def latest_train_state_path(out_dir: str) -> Optional[str]:
    """The newest ``*_state`` file under ``out_dir`` (``--resume auto``),
    ranked by modification time, not by the epoch in the name: a run that
    resumed and stopped again may have left a higher-numbered but older
    file.  Ties break toward ``final_state``, then the higher epoch (JAX
    ``latest_train_state_path``)."""
    cands = [p for p in glob.glob(os.path.join(out_dir, "*_state")) if os.path.isfile(p)]

    def rank(p):
        if p.endswith("final_state"):
            name_rank = (2, 0)
        else:
            m = re.search(r"epoch_(\d+)_state$", p)
            name_rank = (1, int(m.group(1))) if m else (0, 0)
        return (os.path.getmtime(p), *name_rank)

    return max(cands, key=rank) if cands else None
