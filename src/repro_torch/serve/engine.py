"""Prefill/decode serving engine (counterpart of ``repro.serve.engine``).

``build_prefill_step``/``build_decode_step`` return the step functions;
``ServeEngine`` wraps them into a batched greedy/temperature generation
loop over a preallocated KV cache.  Everything runs under
``torch.inference_mode()``.  Greedy decoding follows the reference token
for token; temperature sampling draws from a ``torch.Generator``
(``jax.random.categorical``'s draws cannot be reproduced).  The
``dense``, ``vlm``, ``ssm``, ``moe`` and ``hybrid`` families serve
(``moe``: the compressed MLA caches of its dense and MoE stacks; its MoE
layers route each call's tokens in capacity-bounded groups, so a token's
output depends on the batch it is served in, as in the reference;
``hybrid``: the Mamba2 conv and SSM states and one KV cache a visit of the
shared block).  The ``audio`` family (Whisper, ``models/encdec.py``)
serves from the encoder frames: its prefill step takes ``frames`` and
``generate`` needs them; its decode state holds every layer's cross K/V,
computed once from the encoder memory.

With ``mesh=`` (a ``("data", "model")`` mesh, ``launch.mesh.
make_host_mesh``; every rank makes the same calls with the same inputs)
every family but ``moe`` serves sharded: the model is placed with
``sharding.fsdp.shard_model`` (on its first call, in place, unless it
already is), the decode state holds this rank's rows of the batch (the
``audio`` family's frames too) and what its heads read
(``transformer.init_decode_state(mesh=)``, ``encdec.init_decode_state``),
and every step returns the whole logits on every rank, gathered over the
vocab (and the rows) before sampling, so that every rank samples the same
token from the same generator.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models import encdec as ED, transformer as T
from repro_torch.sharding import fsdp
from repro_torch.utils.devices import resolve_device


def _placed(model, mesh):
    """``model`` placed on ``mesh`` (``fsdp.shard_model`` in place if it is
    not yet sharded); raises for a model sharded on another mesh."""
    if mesh is None or fsdp.mesh_of(model) is mesh:
        return model
    if fsdp.mesh_of(model) is not None:
        raise ValueError("the model is sharded on another mesh")
    return fsdp.shard_model(model, mesh)


def build_prefill_step(cfg, mesh=None) -> Callable:
    """``prefill(model, tokens (B, T), max_len) -> (logits, state)``: a fresh
    decode state filled with the prompt's keys and values.  For ``audio``
    ``prefill(model, tokens, frames (B, T_enc, D), max_len=None)``: the
    frames encoded and every layer's cross K/V projected first; the caches
    hold ``max_len`` positions, by default the prompt's, as the
    reference's (a cache to generate into needs more: the port refuses a
    write past its end).  With ``mesh`` the model serves sharded (the
    module's docstring)."""
    T.check_serving(cfg, mesh)
    if cfg.family == "audio":
        @torch.inference_mode()
        def run_audio(params, tokens, frames, max_len: int | None):
            b, t = tokens.shape
            state = ED.init_decode_state(params, frames, b, t if max_len is None else max_len)
            return ED.decode_step(params, tokens, state, 0, prefill=True)

        def prefill_audio(params, tokens, frames, max_len: int | None = None):
            return run_audio(_placed(params, mesh), tokens, frames, max_len)

        return prefill_audio

    @torch.inference_mode()
    def run(params, tokens, max_len: int):
        state = T.init_decode_state(cfg, tokens.shape[0], max_len, device=tokens.device,
                                    mesh=mesh)
        return T.decode_step(params, tokens, state, 0, prefill=True)

    def prefill(params, tokens, max_len: int):
        return run(_placed(params, mesh), tokens, max_len)

    return prefill


def build_decode_step(cfg, mesh=None) -> Callable:
    """``decode(model, tokens, state, pos) -> (logits, state)``; with
    ``mesh`` on the sharded model and its state."""
    T.check_serving(cfg, mesh)
    step = ED.decode_step if cfg.family == "audio" else T.decode_step

    @torch.inference_mode()
    def run(params, tokens, state, pos: int):
        return step(params, tokens, state, pos)

    def decode(params, tokens, state, pos: int):
        return run(_placed(params, mesh), tokens, state, pos)

    return decode


class ServeEngine:
    """Batched generation over the decode step.  ``params`` is a
    ``Transformer`` (``audio``: an ``EncDec``) on ``device``; with ``mesh``
    it is placed on the mesh here (the module's docstring)."""

    def __init__(self, cfg, params: T.Transformer | ED.EncDec, max_len: int = 256, *,
                 device="cuda", mesh=None):
        self.device = resolve_device(device)
        T.check_serving(cfg, mesh)
        if params.embed.embedding.device != self.device:
            raise ValueError(f"the model lies on {params.embed.embedding.device}, "
                             f"the engine on {self.device}")
        self.cfg = cfg
        self.params = _placed(params, mesh)
        self.mesh = mesh
        self.max_len = max_len
        self._decode = build_decode_step(cfg, mesh)

    @torch.inference_mode()
    def generate(self, prompts: torch.Tensor, n_tokens: int, *,
                 frames: torch.Tensor | None = None, temperature: float = 0.0,
                 generator: torch.Generator | None = None) -> torch.Tensor:
        """``prompts (B, T0)`` followed by ``n_tokens`` new tokens, ``(B, T0 +
        n_tokens)``.  As in the reference, the prompt runs through the
        cached decode path (not the prefill step).  The ``audio`` family
        needs the encoder ``frames (B, T_enc, D)``, encoded once."""
        b, t0 = prompts.shape
        prompts = prompts.to(self.device)
        if self.cfg.family == "audio":
            if frames is None:
                raise ValueError("the audio family generates from encoder frames: pass frames=")
            state = ED.init_decode_state(self.params, frames.to(self.device), b, self.max_len)
        else:
            state = T.init_decode_state(self.cfg, b, self.max_len, device=self.device,
                                        mesh=self.mesh)
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
