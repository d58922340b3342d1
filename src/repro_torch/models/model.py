"""Model facade: init / train-forward / prefill / decode for an ArchConfig.

The JAX package's ``Model``.  ``init`` draws from a ``torch.Generator`` and
puts the parameters on its device; every other method runs where its
tensors are.  ``loss`` is differentiated by ``torch.autograd``
(``train/train_step.py``).
Modality frontends are stubs as in the reference: ``prefix_embeddings``
(precomputed frame/patch embeddings) are prepended to the token
embeddings; loss applies to token positions.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..sharding.constraints import constrain_bsd, constrain_logits
from . import layers as L
from . import transformer as T
from .config import ArchConfig

Params = Dict[str, Any]


class Model:
    def __init__(self, cfg: ArchConfig):
        self.cfg = cfg

    # -- parameters -----------------------------------------------------------

    def init(self, generator: torch.Generator) -> Params:
        return {
            "embedding": L.embedding_init(generator, self.cfg),
            "stack": T.init_stack(generator, self.cfg),
            "final_norm": L.rmsnorm_init(self.cfg, device=generator.device),
        }

    # -- embedding (with modality-prefix stub) ---------------------------------

    def _embed_inputs(
        self, params: Params, tokens: torch.Tensor, prefix: Optional[torch.Tensor]
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = L.embed(params["embedding"], tokens)  # (B, S, D)
        if prefix is not None:
            x = torch.cat([prefix.to(x.dtype), x], dim=1)
        x = constrain_bsd(x)
        b, s, _ = x.shape
        positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
        return x, positions

    # -- train ------------------------------------------------------------------

    def logits_train(
        self,
        params: Params,
        tokens: torch.Tensor,  # (B, S)
        prefix_embeddings: Optional[torch.Tensor] = None,  # (B, P, D)
        remat: bool = True,
    ) -> torch.Tensor:
        cfg = self.cfg
        x, positions = self._embed_inputs(params, tokens, prefix_embeddings)
        x = T.forward_train(params["stack"], cfg, x, positions, remat=remat)
        x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
        if prefix_embeddings is not None:
            x = x[:, prefix_embeddings.shape[1] :]
        return constrain_logits(L.unembed(params["embedding"], cfg, x))

    def loss(
        self,
        params: Params,
        tokens: torch.Tensor,
        labels: torch.Tensor,
        prefix_embeddings: Optional[torch.Tensor] = None,
        remat: bool = True,
    ) -> torch.Tensor:
        logits = self.logits_train(params, tokens, prefix_embeddings, remat=remat)
        logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
        # take_along_axis reads a negative label from the end of the vocab,
        # as the reference does; the mask zeroes its term
        index = torch.where(labels < 0, labels + logp.shape[-1], labels).long()
        nll = -torch.gather(logp, -1, index[..., None])[..., 0]
        mask = labels >= 0
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1)

    # -- serve --------------------------------------------------------------------

    def prefill(
        self,
        params: Params,
        tokens: torch.Tensor,  # (B, S)
        max_len: int,
        prefix_embeddings: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, Params]:
        """Returns (last-position logits, decode cache)."""
        cfg = self.cfg
        x, positions = self._embed_inputs(params, tokens, prefix_embeddings)
        x, cache = T.forward_prefill(params["stack"], cfg, x, positions, max_len)
        x = L.rmsnorm(params["final_norm"], x[:, -1:], cfg.norm_eps)
        return constrain_logits(L.unembed(params["embedding"], cfg, x)), cache

    def decode_step(
        self,
        params: Params,
        token: torch.Tensor,  # (B, 1)
        cache: Params,
        cache_len: int,
    ) -> Tuple[torch.Tensor, Params]:
        """Logits of one token a row at position ``cache_len``; the cache is
        updated in place and returned."""
        cfg = self.cfg
        x = L.embed(params["embedding"], token)
        x, cache = T.forward_decode(params["stack"], cfg, x, cache, int(cache_len))
        x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
        return constrain_logits(L.unembed(params["embedding"], cfg, x)), cache

    def init_cache(self, batch: int, max_len: int, device=None) -> Params:
        """Zero decode cache on ``device`` (cuda unless told otherwise)."""
        return T.init_cache(self.cfg, batch, max_len, device)
