"""Mesh NoC: topology, packetizer, cycle-level simulator, sweep engine."""
from .topology import PAPER_NOCS, NocConfig, make_noc, mesh_by_name
from .sim import SimResult, Traffic, simulate, simulate_batch
from .traffic import (LayerTraffic, build_traffic, build_traffic_batch,
                      build_traffic_streamed)
from .sweep import SweepGrid, SweepReport, run_sweep

__all__ = ["PAPER_NOCS", "NocConfig", "make_noc", "mesh_by_name",
           "SimResult", "Traffic", "simulate", "simulate_batch",
           "LayerTraffic", "build_traffic", "build_traffic_batch",
           "build_traffic_streamed", "SweepGrid", "SweepReport",
           "run_sweep"]
