"""Executable form of the paper's latency model (Section III-A, Eq. 1-5)
— the port's copy of the reference's `core/latency_model.py`.

A decode step moves five kinds of traffic:

  H_r  bytes read from HBM for inference
  E_r  bytes read from off-package DRAM for inference
  H_w / E_w  newly written KV entries to HBM / DRAM
  M_i  KV bytes migrated DRAM -> HBM
  M_o  KV bytes migrated HBM -> DRAM

Eq. (3):  t_h = (H_r + H_w + M_i + M_o) / B_h
Eq. (4):  t_e = E_r / min(B_k, B_d)
               + max( (E_w + M_o)/B_k, M_i / B_k, (E_w + M_i + M_o)/B_d )
Eq. (2):  t   = max(t_h, t_e)
Eq. (1):  T   = sum over steps (the engine's `summary`).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from repro_torch.core.tiers import MemorySystemSpec

Array = Any  # scalar or np.ndarray


@dataclasses.dataclass
class StepTraffic:
    """Per-step traffic volumes in bytes. Fields broadcast together."""

    h_read: Array = 0.0
    e_read: Array = 0.0
    h_write: Array = 0.0
    e_write: Array = 0.0
    m_in: Array = 0.0   # DRAM -> HBM migration
    m_out: Array = 0.0  # HBM -> DRAM migration

    def __add__(self, other: "StepTraffic") -> "StepTraffic":
        """Elementwise sum — aggregate per-layer (or per-lane) traffic
        into one per-step volume before pricing Eq. (2)."""
        return StepTraffic(
            h_read=self.h_read + other.h_read,
            e_read=self.e_read + other.e_read,
            h_write=self.h_write + other.h_write,
            e_write=self.e_write + other.e_write,
            m_in=self.m_in + other.m_in,
            m_out=self.m_out + other.m_out,
        )

    @classmethod
    def from_page_counts(cls, *, n_hbm_read: Array, n_dram_read: Array,
                         n_promote: Array, n_demote: Array,
                         page_bytes: float, h_write: Array = 0.0,
                         e_write: Array = 0.0) -> "StepTraffic":
        """Traffic volumes from page-granular counts — the shape the
        live engine's telemetry and the simulator both emit."""
        return cls(h_read=np.asarray(n_hbm_read, np.float64) * page_bytes,
                   e_read=np.asarray(n_dram_read, np.float64) * page_bytes,
                   h_write=h_write, e_write=e_write,
                   m_in=np.asarray(n_promote, np.float64) * page_bytes,
                   m_out=np.asarray(n_demote, np.float64) * page_bytes)


def degraded_spec(spec: MemorySystemSpec, *, hbm_scale: float = 1.0,
                  link_scale: float = 1.0,
                  dram_scale: float = 1.0) -> MemorySystemSpec:
    """`spec` with its bandwidths scaled — the pricing view of a
    host-tier degradation window (scale < 1 slows the tier). Capacities
    are untouched: a degraded link still addresses the same bytes, it
    just moves them slower. Used by the fault plane
    (`serving.faults`) to price a degraded window and by the
    cost_aware payback recalibration."""
    if min(hbm_scale, link_scale, dram_scale) <= 0.0:
        raise ValueError("bandwidth scales must be positive")
    return dataclasses.replace(
        spec,
        hbm_bw=spec.hbm_bw * hbm_scale,
        link_bw=spec.link_bw * link_scale,
        dram_bw=spec.dram_bw * dram_scale,
    )


def hbm_latency(t: StepTraffic, spec: MemorySystemSpec) -> Array:
    """Eq. (3)."""
    return (t.h_read + t.h_write + t.m_in + t.m_out) / spec.hbm_bw


def dram_latency(t: StepTraffic, spec: MemorySystemSpec) -> Array:
    """Eq. (4)."""
    read_term = t.e_read / spec.effective_dram_read_bw
    link_out = (t.e_write + t.m_out) / spec.link_bw   # toward DRAM
    link_in = t.m_in / spec.link_bw                   # toward HBM
    dram_chan = (t.e_write + t.m_in + t.m_out) / spec.dram_bw
    xfer_term = np.maximum(np.maximum(link_out, link_in), dram_chan)
    return read_term + xfer_term


def step_latency(t: StepTraffic, spec: MemorySystemSpec) -> Array:
    """Eq. (2): the two tiers operate concurrently; the step waits for both."""
    return np.maximum(hbm_latency(t, spec), dram_latency(t, spec))


def total_latency(t: StepTraffic, spec: MemorySystemSpec) -> float:
    """Eq. (1)."""
    return float(np.sum(step_latency(t, spec)))


def tokens_per_second(t: StepTraffic, spec: MemorySystemSpec,
                      num_tokens: int) -> float:
    T = total_latency(t, spec)
    return num_tokens / T if T > 0 else float("inf")


# ---------------------------------------------------------------------------
# Workload byte-accounting helpers
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class KVWorkload:
    """Static byte-accounting for a decode workload on a given model.

    bytes_per_token_layer: KV bytes appended per generated token per layer
                           (2 * kv_heads * head_dim * dtype_bytes).
    weight_bytes_per_layer_step: weight bytes streamed from HBM per layer
                           per decode step (weights are pinned in HBM).
    num_layers, prompt_len, decode_len: trace dimensions.
    """

    bytes_per_token_layer: int
    weight_bytes_per_layer_step: int
    num_layers: int
    prompt_len: int
    decode_len: int

    @property
    def page_bytes(self) -> int:
        raise AttributeError("page size lives in the placement policy")

    def kv_bytes_total(self) -> int:
        return (self.prompt_len + self.decode_len) * self.num_layers \
            * self.bytes_per_token_layer


def gqa_kv_bytes_per_token_layer(kv_heads: int, head_dim: int,
                                 dtype_bytes: int = 2) -> int:
    return 2 * kv_heads * head_dim * dtype_bytes
