"""Sampling parameters and logit transforms for the serving paths
(counterpart of ``ssp_x_vit_tpu/llm/sampling.py``).

vLLM ``SamplingParams`` semantics with HF LogitsProcessor numerics:
temperature / top-k / top-p / min-p filtering plus repetition, presence and
frequency penalties.

- ``repetition_penalty`` applies to tokens present in the prompt or generated
  so far: positive logits divided by p, negative multiplied.
- ``presence_penalty`` / ``frequency_penalty`` apply to generated tokens only:
  ``logits -= presence * 1[count > 0] + frequency * count``.

``SamplerState`` is the per-slot state of a continuous-batching server: ``[b]``
parameter vectors and two ``[b, V]`` buffers on the server's device, and one
seeded ``torch.Generator`` per slot in place of the JAX package's ``[b, 2]``
threefry keys. The random streams of the two frameworks differ, so sampled
tokens are reproducible for a seed within this package only; greedy rows and
the penalty and filter transforms are the same numbers in both. Every step
stays on the device: which rows sample is kept on the host from admission, so
``vectorized_sample`` never reads a device value back.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Static (hashable) sampling configuration for one generation call.

    ``temperature <= 0`` selects greedy argmax (filters are skipped);
    penalties apply in both regimes.
    """

    temperature: float = 0.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    min_p: Optional[float] = None
    repetition_penalty: float = 1.0
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0

    def __post_init__(self):
        if self.top_p is not None and not (0.0 < self.top_p <= 1.0):
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.min_p is not None and not (0.0 <= self.min_p <= 1.0):
            raise ValueError(f"min_p must be in [0, 1], got {self.min_p}")
        if self.repetition_penalty <= 0.0:
            raise ValueError("repetition_penalty must be > 0 (1.0 = off), "
                             f"got {self.repetition_penalty}")

    @property
    def needs_counts(self) -> bool:
        """True when the decode loop must carry the [b, V] penalty buffers."""
        return (self.repetition_penalty != 1.0 or self.presence_penalty != 0.0
                or self.frequency_penalty != 0.0)

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0


_NEG = float("-inf")


def apply_penalties(logits: torch.Tensor, prompt_mask: torch.Tensor, counts: torch.Tensor,
                    sp: SamplingParams) -> torch.Tensor:
    """Penalty transforms on [b, V] logits (before temperature and filters)."""
    if sp.repetition_penalty != 1.0:
        seen = (prompt_mask > 0) | (counts > 0)
        rp = sp.repetition_penalty
        logits = torch.where(seen, torch.where(logits > 0, logits / rp, logits * rp), logits)
    if sp.frequency_penalty != 0.0:
        logits = logits - sp.frequency_penalty * counts
    if sp.presence_penalty != 0.0:
        logits = logits - sp.presence_penalty * (counts > 0).to(logits.dtype)
    return logits


def _nucleus_threshold(srt_desc: torch.Tensor, top_p) -> torch.Tensor:
    """Smallest logit of the sorted prefix whose mass reaches ``top_p``,
    the crossing token included (HF convention): [b, 1]."""
    probs = torch.softmax(srt_desc, dim=-1)
    before = torch.cumsum(probs, dim=-1) - probs
    kept = torch.where(before < top_p, srt_desc, torch.full_like(srt_desc, float("inf")))
    return kept.min(dim=-1, keepdim=True).values


def filter_logits(scaled: torch.Tensor, sp: SamplingParams) -> torch.Tensor:
    """top-k / top-p / min-p filters on temperature-scaled logits [b, V]."""
    neg = torch.full_like(scaled, _NEG)
    if sp.top_k is not None:
        kth = torch.sort(scaled, dim=-1).values[:, -sp.top_k][:, None]
        scaled = torch.where(scaled >= kth, scaled, neg)
    if sp.top_p is not None and sp.top_p < 1.0:
        srt = torch.sort(scaled, dim=-1, descending=True).values
        scaled = torch.where(scaled >= _nucleus_threshold(srt, sp.top_p), scaled, neg)
    if sp.min_p is not None and sp.min_p > 0.0:
        max_logit = scaled.max(dim=-1, keepdim=True).values
        scaled = torch.where(scaled >= max_logit + math.log(sp.min_p), scaled, neg)
    return scaled


@dataclasses.dataclass
class SamplerState:
    """Per-slot sampler state of a continuous-batching server
    (``llm/paged.PagedServer``): each row belongs to one slot and is reset at
    admission. Tensors live on the server's device."""

    generators: List[Optional[torch.Generator]]  # one per slot, seeded at admission
    sampled: List[bool]      # host copy of temperature > 0, per slot
    temperature: torch.Tensor  # [b] f32, <= 0 -> greedy row
    top_k: torch.Tensor        # [b] i64, 0 -> disabled
    top_p: torch.Tensor        # [b] f32, >= 1 -> disabled
    min_p: torch.Tensor        # [b] f32, 0 -> disabled
    repetition: torch.Tensor   # [b] f32, 1 -> disabled
    presence: torch.Tensor     # [b] f32, 0 -> disabled
    frequency: torch.Tensor    # [b] f32, 0 -> disabled
    prompt_mask: torch.Tensor  # [b, V] f32 prompt presence
    counts: torch.Tensor       # [b, V] f32 generated counts


def init_sampler_state(max_batch: int, vocab_size: int, device="cpu") -> SamplerState:
    """All-neutral state (greedy rows, empty penalty buffers) on ``device``."""
    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float32, device=device)

    return SamplerState(
        generators=[None] * max_batch, sampled=[False] * max_batch,
        temperature=z(max_batch), top_k=torch.zeros(max_batch, dtype=torch.int64, device=device),
        top_p=ones(max_batch), min_p=z(max_batch), repetition=ones(max_batch),
        presence=z(max_batch), frequency=z(max_batch),
        prompt_mask=z(max_batch, vocab_size), counts=z(max_batch, vocab_size))


def slot_state_row(state: SamplerState, i: int, sp: SamplingParams,
                   prompt_tokens: Sequence[int], vocab_size: int,
                   seed: Optional[int]) -> SamplerState:
    """Admission-time reset of row ``i`` from a SamplingParams and the prompt
    (in place; returns ``state``). The slot's generator restarts from ``seed``
    (0 when None), so a request's tokens depend on its seed, not on the slot's
    previous occupant."""
    device = state.counts.device
    gen = torch.Generator(device=device)
    gen.manual_seed(0 if seed is None else int(seed))
    state.generators[i] = gen
    state.sampled[i] = sp.temperature > 0.0
    state.temperature[i] = max(sp.temperature, 0.0)
    state.top_k[i] = sp.top_k or 0
    state.top_p[i] = sp.top_p if sp.top_p is not None else 1.0
    state.min_p[i] = sp.min_p or 0.0
    state.repetition[i] = sp.repetition_penalty
    state.presence[i] = sp.presence_penalty
    state.frequency[i] = sp.frequency_penalty
    state.prompt_mask[i] = 0.0
    state.prompt_mask[i, torch.as_tensor(list(prompt_tokens), dtype=torch.int64, device=device)] = 1.0
    state.counts[i] = 0.0
    return state


def penalized_logits(logits: torch.Tensor, state: SamplerState) -> torch.Tensor:
    """Per-row penalties on [b, V] logits in fp32 (neutral rows are exact no-ops)."""
    z = logits.float()
    seen = (state.prompt_mask > 0) | (state.counts > 0)
    rp = state.repetition[:, None]
    z = torch.where(seen, torch.where(z > 0, z / rp, z * rp), z)
    z = z - state.frequency[:, None] * state.counts
    return z - state.presence[:, None] * (state.counts > 0).float()


def filtered_logits(z: torch.Tensor, state: SamplerState) -> torch.Tensor:
    """Per-row temperature scaling and top-k / top-p / min-p filters on
    penalized logits: the largest of the three thresholds, each taken on the
    unfiltered scaled row; filtered entries are -inf."""
    V = z.shape[1]
    neg = torch.full((), _NEG, dtype=z.dtype, device=z.device)
    scaled = z / state.temperature.clamp_min(1e-6)[:, None]
    srt = torch.sort(scaled, dim=-1, descending=True).values
    kth = srt.gather(1, (state.top_k - 1).clamp(0, V - 1)[:, None])
    k_thresh = torch.where(state.top_k[:, None] > 0, kth, neg)
    p_thresh = torch.where(state.top_p[:, None] < 1.0,
                           _nucleus_threshold(srt, state.top_p[:, None]), neg)
    m_thresh = torch.where(
        state.min_p[:, None] > 0.0,
        scaled.max(dim=-1, keepdim=True).values + torch.log(state.min_p.clamp_min(1e-30))[:, None],
        neg)
    thresh = torch.maximum(torch.maximum(k_thresh, p_thresh), m_thresh)
    return torch.where(scaled >= thresh, scaled, neg)


def vectorized_sample(logits: torch.Tensor, state: SamplerState,
                      rows: Optional[Sequence[int]] = None
                      ) -> Tuple[torch.Tensor, SamplerState]:
    """Sample every slot of a [b, V] logits batch with its own knobs: per-row
    penalties, temperature (<= 0: greedy argmax for that row), top-k / top-p /
    min-p, and the slot's own generator (Gumbel-max over the filtered row).
    ``rows`` names the slots the batch rows belong to (default: row i is slot
    i). Returns (tokens [b] int64, the state with updated counts)."""
    slots = list(range(logits.shape[0])) if rows is None else list(rows)
    view = state
    if rows is not None:  # admission samples one slot's row
        idx = torch.as_tensor(slots, dtype=torch.int64, device=logits.device)
        view = dataclasses.replace(state, **{
            f.name: getattr(state, f.name)[idx] for f in dataclasses.fields(state)
            if f.name not in ("generators", "sampled")})
    z = penalized_logits(logits, view)
    tok = z.argmax(dim=-1)
    sampled = [r for r, s in enumerate(slots) if state.sampled[s]]
    if sampled:
        filtered = filtered_logits(z, view)
        for r in sampled:
            u = torch.rand(filtered.shape[1], generator=state.generators[slots[r]],
                           device=logits.device, dtype=torch.float32)
            gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
            tok[r] = (filtered[r] + gumbel).argmax()
    state.counts[torch.as_tensor(slots, dtype=torch.int64, device=logits.device), tok] += 1.0
    return tok, state
