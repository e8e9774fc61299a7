"""Mesh NoC: topology, packetizer (request and result phases, MSR
compression), cycle-level simulator (with the packet ledger), fault
injection (soft errors, protection, retries, dead links and routers),
closed-loop serving (arrival processes, admission control), sweep engine,
drain autotune, power model."""
from .topology import (AFFINITIES, PAPER_NOCS, PLACEMENTS, NocConfig,
                       affinity_mc_table, alive_link_mask, fault_route_table,
                       make_noc, mc_placement, mesh_by_name, packet_mean_hops)
from .sim import DrainTimeout, SimResult, Traffic, simulate, simulate_batch
from .traffic import (LayerTraffic, build_result_traffic, build_traffic,
                      build_traffic_batch, build_traffic_streamed,
                      concat_inferences, filter_packets, layer_results)
from .online import (ARRIVAL_KINDS, ArrivalProcess, OnlineResult,
                     latency_percentiles, percentile, simulate_online)
from .sweep import SweepGrid, SweepReport, run_serving, run_sweep
from .faults import (FaultDrain, FaultModel, StepFaults, STATUS_DELIVERED,
                     STATUS_DROPPED, STATUS_RETRY_EXHAUSTED, STATUS_UNSENT,
                     drain_with_retries, protect_wire, simulate_faulty,
                     simulate_faulty_batch)
from . import power, tune

__all__ = ["PAPER_NOCS", "PLACEMENTS", "AFFINITIES", "NocConfig", "make_noc",
           "mc_placement", "mesh_by_name", "affinity_mc_table",
           "packet_mean_hops", "alive_link_mask", "fault_route_table",
           "DrainTimeout", "SimResult", "Traffic", "simulate",
           "simulate_batch", "LayerTraffic", "build_traffic",
           "build_traffic_batch", "build_traffic_streamed",
           "build_result_traffic", "filter_packets", "layer_results",
           "concat_inferences", "ArrivalProcess", "OnlineResult",
           "simulate_online", "percentile", "latency_percentiles",
           "ARRIVAL_KINDS", "SweepGrid", "SweepReport", "run_sweep",
           "run_serving",
           "FaultModel", "FaultDrain", "StepFaults", "protect_wire",
           "drain_with_retries", "simulate_faulty", "simulate_faulty_batch",
           "STATUS_DELIVERED", "STATUS_DROPPED", "STATUS_RETRY_EXHAUSTED",
           "STATUS_UNSENT", "power", "tune"]
