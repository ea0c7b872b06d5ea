"""Prefill/decode serving engine (counterpart of ``repro.serve.engine``).

``build_prefill_step``/``build_decode_step`` return the step functions;
``ServeEngine`` wraps them into a batched greedy/temperature generation
loop over a preallocated KV cache.  Everything runs under
``torch.inference_mode()``.  Greedy decoding follows the reference token
for token; temperature sampling draws from a ``torch.Generator``
(``jax.random.categorical``'s draws cannot be reproduced).  The ``audio``
family (encoder-decoder) is not ported yet and raises.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models import transformer as T
from repro_torch.utils.devices import resolve_device


def build_prefill_step(cfg) -> Callable:
    """``prefill(model, tokens (B, T), max_len) -> (logits, state)``: a fresh
    decode state filled with the prompt's keys and values."""
    T.check_serving(cfg)

    @torch.inference_mode()
    def prefill(params, tokens, max_len: int):
        state = T.init_decode_state(cfg, tokens.shape[0], max_len, device=tokens.device)
        return T.decode_step(params, tokens, state, 0, prefill=True)

    return prefill


def build_decode_step(cfg) -> Callable:
    """``decode(model, tokens, state, pos) -> (logits, state)``."""
    T.check_serving(cfg)

    @torch.inference_mode()
    def decode(params, tokens, state, pos: int):
        return T.decode_step(params, tokens, state, pos)

    return decode


class ServeEngine:
    """Batched generation over the decode step.  ``params`` is a
    ``Transformer`` on ``device``."""

    def __init__(self, cfg, params: T.Transformer, max_len: int = 256, *, device="cuda"):
        self.device = resolve_device(device)
        T.check_serving(cfg)
        if params.embed.embedding.device != self.device:
            raise ValueError(f"the model lies on {params.embed.embedding.device}, "
                             f"the engine on {self.device}")
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self._decode = build_decode_step(cfg)

    @torch.inference_mode()
    def generate(self, prompts: torch.Tensor, n_tokens: int, *, temperature: float = 0.0,
                 generator: torch.Generator | None = None) -> torch.Tensor:
        """``prompts (B, T0)`` followed by ``n_tokens`` new tokens, ``(B, T0 +
        n_tokens)``.  As in the reference, the prompt runs through the
        cached decode path (not the prefill step)."""
        b, t0 = prompts.shape
        prompts = prompts.to(self.device)
        state = T.init_decode_state(self.cfg, b, self.max_len, device=self.device)
        logits, state = self._decode(self.params, prompts, state, 0)
        out = [prompts]
        tok = self._sample(logits[:, -1:], temperature, generator)
        for i in range(n_tokens - 1):
            out.append(tok)
            logits, state = self._decode(self.params, tok, state, t0 + i)
            tok = self._sample(logits[:, -1:], temperature, generator)
        out.append(tok)
        return torch.cat(out, dim=1)

    @staticmethod
    def _sample(logits, temperature, generator):
        """``(B, 1)`` tokens from the last position's ``(B, 1, V)`` logits."""
        if temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits[:, 0] / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)
