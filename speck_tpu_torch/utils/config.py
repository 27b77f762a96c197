"""Runtime configuration: the INI store and the pipeline knobs.

``SpgemmConfig`` has the same fields and defaults as ``speck_tpu``'s, so
one configuration drives both packages. The port runs every route and
takes every value of the A/B knobs that ``speck_tpu`` names: every
``stream_expand_impl`` name runs the one expand (K4 on the card) and every
``stream_sort_impl`` name the one row sort (K2), the reference's forms of
one function each; ``check_knobs`` (ops/spgemm.py) raises ValueError for a
value it does not name.
"""

from __future__ import annotations

import configparser
import dataclasses
from typing import Optional


class ProductOverflow(ValueError):
    """Total intermediate products (or the quantized stream they pack
    into) exceed one plan's int32 budget."""


class Config:
    """INI config with defaults; section-less files accepted."""

    _instance: Optional["Config"] = None

    def __init__(self, path: Optional[str] = None):
        self._cp = configparser.ConfigParser()
        self._cp.optionxform = str  # keys are case-sensitive
        if path:
            with open(path) as fh:
                text = fh.read()
            if not text.lstrip().startswith("["):
                text = "[default]\n" + text
            self._cp.read_string(text)

    @classmethod
    def init(cls, path: Optional[str] = None) -> "Config":
        cls._instance = Config(path)
        return cls._instance

    @classmethod
    def get(cls) -> "Config":
        if cls._instance is None:
            cls._instance = Config(None)
        return cls._instance

    def _raw(self, key: str, fallback=None):
        for section in self._cp.sections():
            if self._cp.has_option(section, key):
                return self._cp.get(section, key)
        return fallback

    def get_string(self, key: str, default: str = "") -> str:
        v = self._raw(key)
        return default if v is None else str(v)

    def get_int(self, key: str, default: int = 0) -> int:
        v = self._raw(key)
        try:
            return default if v is None else int(str(v).strip())
        except ValueError:
            return default

    def get_float(self, key: str, default: float = 0.0) -> float:
        v = self._raw(key)
        try:
            return default if v is None else float(str(v).strip())
        except ValueError:
            return default

    def get_bool(self, key: str, default: bool = False) -> bool:
        v = self._raw(key)
        if v is None:
            return default
        return str(v).strip().lower() in ("1", "true", "yes", "on")


@dataclasses.dataclass(frozen=True)
class SpgemmConfig:
    """Tuning knobs of the SpGEMM pipeline (``speck_tpu``'s fields and
    defaults; see ``speck_tpu/utils/config.py`` for each one's history)."""

    product_budget: int = 1 << 22  # max stream slots per chunk (~4M)
    mesh_split_min_ops: int = 1 << 25
    mesh_subrow_max_ops: int = 1 << 30
    mesh_balance_rows: bool = True
    mesh_exchange_auto: bool = True
    mesh_round_pad_exact: bool = True
    mesh_device_planning: bool = True
    # analysis + routing gates on host numpy when the inputs carry their
    # HostCSR copies (device_put_csr attaches them)
    host_analysis: bool = True
    host_analysis_max_nnz: int = 8 << 20
    # rectangle-row width of the product stream and its adaptive ceiling
    stream_width: int = 8192
    stream_width_cap: int = 65536
    block_products: int = 1 << 30
    stream_min_q: int = 8        # smallest per-row product quantum (pow2)
    stream_level_factor: int = 4
    stream_max_width: int = 1 << 24
    stream_pallas_contract: bool = False
    # every name runs the one row sort (K2) and the one expand (K4)
    stream_sort_impl: str = "auto"
    stream_expand_impl: str = "fill"
    stream_compact_impl: str = "sort"
    enable_accum: bool = False
    accum_min_ops: int = 1 << 14
    accum_span_cap: int = 1 << 20
    accum_budget: int = 1 << 26
    # staged int32 planes (3 per stream slot) kept between counting and
    # numeric; past this the numeric phase re-expands (two-phase)
    fused_staging_budget: int = 1 << 28
    enable_direct: bool = True    # direct-copy chunks for single-A-nnz rows
    enable_dia: bool = True
    enable_sdia: bool = True
    sdia_span_cap: int = 1 << 22
    sdia_pair_cap: int = 4096
    dia_gate_early: bool = True
    dia_uniform_emit: bool = True
    dia_span_cap: int = 512
    dia_waste_cap: float = 8.0
    dia_mem_budget: int = 1 << 32
    dia_rows: bool = True
    enable_dense: bool = True
    dense_tile_rows: int = 256
    dense_kw: int = 512
    dense_cw: int = 512
    dense_la: int = 64
    dense_lb: int = 64
    dense_tiles_per_dispatch: int = 256
    dense_densify: str = "sort"

    def __post_init__(self):
        # the stream layout assumes power-of-two quanta and widths
        for f in ("stream_min_q", "stream_width", "stream_width_cap"):
            v = getattr(self, f)
            if v < 1 or v & (v - 1):
                object.__setattr__(
                    self, f, 1 << max(int(v) - 1, 0).bit_length())


# INI key -> SpgemmConfig field
_INI_TUNING_KEYS = {
    "ProductBudget": ("product_budget", int),
    "HostAnalysis": ("host_analysis", bool),
    "HostAnalysisMaxNnz": ("host_analysis_max_nnz", int),
    "MeshSplitMinOps": ("mesh_split_min_ops", int),
    "MeshSubrowMaxOps": ("mesh_subrow_max_ops", int),
    "MeshBalanceRows": ("mesh_balance_rows", bool),
    "MeshExchangeAuto": ("mesh_exchange_auto", bool),
    "MeshRoundPadExact": ("mesh_round_pad_exact", bool),
    "MeshDevicePlanning": ("mesh_device_planning", bool),
    "StreamWidth": ("stream_width", int),
    "StreamWidthCap": ("stream_width_cap", int),
    "BlockProducts": ("block_products", int),
    "StreamMinQ": ("stream_min_q", int),
    "StreamMaxWidth": ("stream_max_width", int),
    "FusedStagingBudget": ("fused_staging_budget", int),
    "EnableDense": ("enable_dense", bool),
    "EnableDirect": ("enable_direct", bool),
    "EnableDia": ("enable_dia", bool),
    "DiaGateEarly": ("dia_gate_early", bool),
    "DiaUniformEmit": ("dia_uniform_emit", bool),
    "DiaSpanCap": ("dia_span_cap", int),
    "DiaWasteCap": ("dia_waste_cap", float),
    "DiaMemBudget": ("dia_mem_budget", int),
    "DiaRows": ("dia_rows", bool),
    "EnableSdia": ("enable_sdia", bool),
    "SdiaSpanCap": ("sdia_span_cap", int),
    "SdiaPairCap": ("sdia_pair_cap", int),
    "EnableAccum": ("enable_accum", bool),
    "AccumMinOps": ("accum_min_ops", int),
    "AccumSpanCap": ("accum_span_cap", int),
    "DenseTileRows": ("dense_tile_rows", int),
    "DenseDensify": ("dense_densify", str),
    "StreamPallasContract": ("stream_pallas_contract", bool),
    "StreamSortImpl": ("stream_sort_impl", str),
    "StreamCompactImpl": ("stream_compact_impl", str),
    "StreamExpandImpl": ("stream_expand_impl", str),
}


def spgemm_config_from_ini(ini: "Config") -> SpgemmConfig:
    """SpgemmConfig with any tuning keys present in the INI applied."""
    overrides = {}
    for key, (field, typ) in _INI_TUNING_KEYS.items():
        if ini.get_string(key, "") == "":
            continue
        if typ is bool:
            overrides[field] = ini.get_bool(key)
        elif typ is int:
            overrides[field] = ini.get_int(key)
        elif typ is float:
            overrides[field] = ini.get_float(key)
        else:
            overrides[field] = ini.get_string(key)
    return SpgemmConfig(**overrides)
