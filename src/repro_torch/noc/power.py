"""Link-power and ordering-unit overhead model (paper Sec. V-C, Tab. II).

The port's copy of ``repro.noc.power`` (pure Python, equal to the reference
to the last float bit).

All constants are the paper's synthesis results (TSMC 90nm, 125 MHz, 1.0V)
and its two link-energy models: the authors' Innovus extraction (0.173
pJ/transition) and Banerjee et al.'s (0.532 pJ/transition). The functions
reproduce the paper's own worked example:

    0.173 pJ/bit * (128 bits / 2) * 112 links * 125 MHz = 155.008 mW
"""
from __future__ import annotations

import dataclasses

__all__ = ["HWConstants", "HW", "link_power_mw", "paper_example",
           "ordering_overhead_mw", "net_power_saving_mw"]


@dataclasses.dataclass(frozen=True)
class HWConstants:
    freq_hz: float = 125e6
    e_bit_ours_pj: float = 0.173        # per-transition energy, Innovus
    e_bit_banerjee_pj: float = 0.532    # Banerjee et al. [6]
    ordering_unit_mw: float = 2.213     # one unit (Tab. II)
    ordering_unit_kge: float = 12.91
    router_mw: float = 16.92
    router_kge: float = 125.54


HW = HWConstants()


def link_power_mw(toggles_per_cycle: float, *, num_links: int = 1,
                  e_bit_pj: float = HW.e_bit_ours_pj,
                  freq_hz: float = HW.freq_hz) -> float:
    """Average link power given mean toggling bits per link per cycle."""
    return e_bit_pj * 1e-12 * toggles_per_cycle * num_links * freq_hz * 1e3


def paper_example(e_bit_pj: float = HW.e_bit_ours_pj) -> float:
    """The paper's illustrative number: half of a 128-bit link toggling,
    112 inter-router links, 125 MHz -> 155.008 mW (ours) / 476.672 mW [6]."""
    return link_power_mw(128 / 2, num_links=112, e_bit_pj=e_bit_pj)


def ordering_overhead_mw(num_mcs: int, separated: bool = False) -> float:
    """Ordering units' power: one per MC; separated-ordering runs the unit
    twice per payload (paper Sec. V-C: 'double time consumption'), modeled
    as doubled dynamic power."""
    scale = 2.0 if separated else 1.0
    return HW.ordering_unit_mw * num_mcs * scale


def net_power_saving_mw(baseline_toggles_per_cycle: float,
                        bt_reduction_rate: float, num_links: int,
                        num_mcs: int, *, separated: bool = False,
                        e_bit_pj: float = HW.e_bit_ours_pj) -> dict:
    """End-to-end accounting: link power saved minus ordering-unit cost."""
    base = link_power_mw(baseline_toggles_per_cycle, num_links=num_links,
                         e_bit_pj=e_bit_pj)
    reduced = base * (1.0 - bt_reduction_rate)
    overhead = ordering_overhead_mw(num_mcs, separated)
    return {
        "baseline_link_mw": base,
        "ordered_link_mw": reduced,
        "ordering_units_mw": overhead,
        "net_saving_mw": base - reduced - overhead,
    }
