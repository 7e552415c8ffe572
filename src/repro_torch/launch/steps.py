"""Step-function builders for serving: prefill and one decode step.

The port of the serve half of the JAX package's ``launch/steps.py``
(``make_prefill_step``, ``make_serve_step``).  PyTorch runs eagerly, so a
step is a plain function; the training step waits for the training slice.
"""
from __future__ import annotations

from typing import Union

import torch

from repro_torch.configs.base import ShapeSpec
from repro_torch.models.model_zoo import Model


def make_prefill_step(model: Model, shape: ShapeSpec):
    def prefill_step(params, batch):
        return model.prefill(params, batch, max_len=shape.seq_len)
    return prefill_step


def make_serve_step(model: Model, shape: ShapeSpec, sample_topk: int = 0):
    """One decode step: token -> logits -> (sampled) next token + new state.

    With ``sample_topk > 0`` the next token comes from top-k sampling
    through the port's ``repro_torch.sort.topk`` front door
    (``cfg.sort_method``, default ``"auto"``, so the planner may route it to
    K4's selection or K5's bitonic top-k), then the Gumbel-max trick over
    the k candidates.  ``rng`` is a ``torch.Generator`` on the model's
    device, or a tensor of uniforms of shape (B, k) for the noise; the
    global RNG state is never read.  With ``sample_topk == 0`` the step is
    greedy and ``rng`` is ignored.
    """
    method = model.cfg.sort_method

    def serve_step(params, token, state,
                   rng: Union[torch.Generator, torch.Tensor, None] = None):
        logits, new_state = model.decode_step(params, token, state)
        if sample_topk:
            from repro_torch import sort as sorting
            v, i = sorting.topk(logits, sample_topk, method=method,
                                device=logits.device)
            if isinstance(rng, torch.Tensor):
                u = rng.to(device=v.device, dtype=torch.float32)
                if u.shape != v.shape:
                    raise ValueError(f"serve_step: uniforms of shape "
                                     f"{tuple(u.shape)}, need "
                                     f"{tuple(v.shape)}")
            elif isinstance(rng, torch.Generator):
                u = torch.rand(v.shape, generator=rng, device=v.device)
            else:
                raise TypeError("serve_step: sampling needs a "
                                "torch.Generator or a tensor of uniforms")
            gumbel = -torch.log(-torch.log(u + 1e-9) + 1e-9)
            choice = torch.argmax(v + gumbel, dim=-1)
            nxt = torch.gather(i, -1, choice[..., None])
        else:
            nxt = torch.argmax(logits, dim=-1)[..., None]
        return nxt.to(torch.int32), new_state

    return serve_step
