"""Gradient clipping for the eager ``minimize``.

Counterpart of `paddle_tpu/fluid/clip.py`: ``GradientClipByValue``,
``GradientClipByNorm`` and ``GradientClipByGlobalNorm``, each called on
the ``[(param, grad)]`` pairs and returning new pairs; a parameter whose
``need_clip`` attribute is False keeps its gradient.  Norms come from
`torch._foreach_norm` and the scales stay on the device: no clip reads a
value back to the host.
"""

from __future__ import annotations

import torch

__all__ = ["ClipByGlobalNorm", "ClipByNorm", "ClipByValue",
           "GradientClipBase", "GradientClipByGlobalNorm",
           "GradientClipByNorm", "GradientClipByValue", "set_gradient_clip"]


class GradientClipBase:
    def __call__(self, params_grads):
        """New ``[(param, grad)]`` pairs, in the same order."""
        raise NotImplementedError

    @staticmethod
    def _split(params_grads):
        params_grads = list(params_grads)
        idx = [i for i, (p, _) in enumerate(params_grads)
               if getattr(p, "need_clip", True)]
        return params_grads, idx

    @staticmethod
    def _merge(params_grads, idx, grads):
        out = list(params_grads)
        for i, g in zip(idx, grads):
            out[i] = (out[i][0], g)
        return out


class GradientClipByValue(GradientClipBase):
    """Each element into ``[min, max]`` (min defaults to ``-max``)."""

    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

    def __call__(self, params_grads):
        params_grads, idx = self._split(params_grads)
        grads = [params_grads[i][1] for i in idx]
        if grads:
            grads = torch._foreach_clamp_min(grads, self.min)
            torch._foreach_clamp_max_(grads, self.max)
        return self._merge(params_grads, idx, grads)


class GradientClipByNorm(GradientClipBase):
    """Each gradient times ``clip_norm / max(‖g‖, clip_norm)``."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        params_grads, idx = self._split(params_grads)
        grads = [params_grads[i][1] for i in idx]
        if grads:
            norms = torch.stack(torch._foreach_norm(grads))
            scale = torch.full_like(norms, self.clip_norm) / torch.clamp_min(
                norms, self.clip_norm)
            grads = torch._foreach_mul(grads, [s.to(g.dtype) for s, g in
                                               zip(scale.unbind(), grads)])
        return self._merge(params_grads, idx, grads)


class GradientClipByGlobalNorm(GradientClipBase):
    """Every clipped gradient times ``clip_norm / max(global_norm,
    clip_norm)``, the global norm over all of them."""

    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def __call__(self, params_grads):
        params_grads, idx = self._split(params_grads)
        grads = [params_grads[i][1] for i in idx]
        if not grads:
            return params_grads
        norms = torch.stack([n.float() for n in torch._foreach_norm(grads)])
        global_norm = norms.square().sum().sqrt()
        scale = (torch.full_like(global_norm, self.clip_norm)
                 / torch.clamp_min(global_norm, self.clip_norm))
        grads = torch._foreach_mul(grads, scale)
        return self._merge(params_grads, idx, grads)


# legacy API names
ClipByValue = GradientClipByValue
ClipByNorm = GradientClipByNorm
ClipByGlobalNorm = GradientClipByGlobalNorm


def set_gradient_clip(clip, param_list=None, program=None):
    raise NotImplementedError(
        "set_gradient_clip is deprecated in the reference too — pass "
        "grad_clip= to the optimizer instead")
