"""Mesh NoC: topology, packetizer (request and result phases, MSR
compression), cycle-level simulator (with the packet ledger), sweep engine,
drain autotune, power model."""
from .topology import (AFFINITIES, PAPER_NOCS, PLACEMENTS, NocConfig,
                       affinity_mc_table, make_noc, mc_placement,
                       mesh_by_name, packet_mean_hops)
from .sim import SimResult, Traffic, simulate, simulate_batch
from .traffic import (LayerTraffic, build_result_traffic, build_traffic,
                      build_traffic_batch, build_traffic_streamed,
                      layer_results)
from .sweep import SweepGrid, SweepReport, run_sweep
from . import power, tune

__all__ = ["PAPER_NOCS", "PLACEMENTS", "AFFINITIES", "NocConfig", "make_noc",
           "mc_placement", "mesh_by_name", "affinity_mc_table",
           "packet_mean_hops", "SimResult", "Traffic", "simulate",
           "simulate_batch", "LayerTraffic", "build_traffic",
           "build_traffic_batch", "build_traffic_streamed",
           "build_result_traffic", "layer_results", "SweepGrid",
           "SweepReport", "run_sweep", "power", "tune"]
