"""The port's state_dicts -> ASV-Subtools checkpoints (counterpart:
asv_subtools_tpu/reverse_convert.py:40-215).

A model trained or served by the port goes back into the reference stack
by a value-traced inversion of the forward converters (convert.py), each
a pure reindexing of reference tensors into the port's keys. The forward
converter runs twice on tagged templates of the reference state_dict:

  pass 1: every tensor filled with its tensor id   -> which reference tensor
  pass 2: every tensor filled with arange(numel)   -> which position in it

Both codes stay far below 2^24, so they survive the converters' float32
casts exactly. The inversion is then a scatter:

* it is exact for any reindexing converter, whatever its structure;
* a converter that does arithmetic (a fold) turns codes into non-integers
  and raises ``ValueError``, unless its scale tensors are pinned by
  ``freeze`` (the ReConformer: exp(0) = 1, the folded weight goes back as
  it is);
* positions no port leaf covers (the reference TdnnAffine's masked context
  taps, ``num_batches_tracked``) are 0, and ``uncovered`` counts them per
  reference key;
* a position covered by two port leaves (tied weights) warns, and the
  export takes the last leaf's values (``shared``).
"""

from __future__ import annotations

import warnings
from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch


def _check_int(vals: np.ndarray, lo: int, hi: int, what: str) -> None:
    if vals.size and (not np.all(vals == np.round(vals)) or np.any((vals < lo) | (vals > hi))):
        raise ValueError(f"{what}: forward converter is not a pure reindexing "
                         "(tag codes were transformed arithmetically)")


class ReverseConverter:
    """Invert a forward converter for one model family.

        rc = ReverseConverter(convert_fn, reference_state_dict)
        sd = rc(port_state_dict)          # {reference key: CPU tensor}

    ``convert_fn(sd) -> {port key: tensor}`` must be a pure reindexing,
    except for the tensors that ``freeze(key)`` selects: those are pinned
    to 0 while tracing and in the export. The template gives the
    reference's keys, shapes and types (its values are not read).
    """

    def __init__(self, convert_fn: Callable, template_sd: Mapping[str, torch.Tensor],
                 freeze: Optional[Callable[[str], bool]] = None):
        self._keys = list(template_sd.keys())
        self._shapes = {k: tuple(v.shape) for k, v in template_sd.items()}
        self._dtypes = {k: v.dtype for k, v in template_sd.items()}
        self._numel = {k: int(np.prod(s)) if s else 1 for k, s in self._shapes.items()}
        self._frozen = {k for k in self._keys if freeze and freeze(k)}
        max_numel = max(self._numel.values())
        n_tensors = len(self._keys)

        def tagged(fill):
            out = {}
            for tid, k in enumerate(self._keys):
                vals = (np.zeros(self._numel[k], np.float64) if k in self._frozen
                        else fill(tid, self._numel[k]).astype(np.float64))
                out[k] = torch.from_numpy(vals.reshape(self._shapes[k]))
            return out

        ids = convert_fn(tagged(lambda tid, n: np.full(n, tid + 1.0)))  # 1-based tensor ids
        poss = convert_fn(tagged(lambda tid, n: np.arange(n, dtype=np.float64)))
        if set(ids) != set(poss):  # the converter must be deterministic
            raise ValueError("converter output structure varied")
        self._leaf_maps: Dict[str, tuple] = {}
        for key in sorted(ids):
            tid = ids[key].detach().cpu().numpy().astype(np.float64).ravel()
            pos = poss[key].detach().cpu().numpy().astype(np.float64).ravel()
            _check_int(tid, 1, n_tensors, f"{key} (ids)")
            _check_int(pos, 0, max_numel - 1, f"{key} (pos)")
            self._leaf_maps[key] = (tid.astype(np.int64) - 1, pos.astype(np.int64))

        counts = {k: np.zeros(self._numel[k], np.int32) for k in self._keys}
        for tid, pos in self._leaf_maps.values():
            for t in np.unique(tid):
                np.add.at(counts[self._keys[t]], pos[tid == t], 1)
        self.uncovered = {k: int((c == 0).sum()) for k, c in counts.items() if (c == 0).any()}
        self.shared = {k: int((c > 1).sum()) for k, c in counts.items() if (c > 1).any()}
        if self.shared:
            warnings.warn(f"reverse conversion with weight tying (reference positions covered by several port "
                          f"leaves): {self.shared}; the export uses the last leaf's values", stacklevel=2)

    def __call__(self, state_dict: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The port's state_dict -> the reference's (CPU tensors in the
        template's types); uncovered positions are 0. A 0-d tensor
        (``num_batches_tracked``) comes back with shape ``[1]``, as JAX's
        export gives it (np.ascontiguousarray); torch's load_state_dict
        takes it for the 0-d buffer."""
        flats = {k: np.zeros(self._numel[k], np.float64) for k in self._keys}
        for key, (tid, pos) in self._leaf_maps.items():
            if key not in state_dict:
                raise KeyError(f"missing leaf {key} in the state_dict")
            vals = state_dict[key].detach().cpu().numpy().astype(np.float64).ravel()
            for t in np.unique(tid):
                m = tid == t
                flats[self._keys[t]][pos[m]] = vals[m]
        return {k: torch.from_numpy(np.ascontiguousarray(flats[k].reshape(self._shapes[k]))).to(self._dtypes[k])
                for k in self._keys}


def export_to_reference(state_dict: Mapping[str, torch.Tensor], convert_fn: Callable,
                        template_sd: Mapping[str, torch.Tensor], loss_state: Optional[Mapping] = None,
                        loss_reverse: Optional[Callable] = None) -> Dict[str, torch.Tensor]:
    """One call: a backbone's state_dict back to the reference's, and the
    loss head's too through ``loss_reverse(loss_state) -> {key: tensor}``."""
    sd = ReverseConverter(convert_fn, template_sd)(state_dict)
    if loss_state is not None and loss_reverse is not None:
        sd.update(loss_reverse(loss_state))
    return sd


def margin_loss_reverse(loss_state: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The margin head back to the reference's conv-style weight: the port's
    ``{"loss.weight": [T, E]}`` (SpeakerNet's keys) -> ``{"loss.weight":
    [T, E, 1]}`` in float32."""
    w = loss_state["loss.weight"].detach().cpu().to(torch.float32)
    return {"loss.weight": w[:, :, None].contiguous()}
