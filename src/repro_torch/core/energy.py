"""Analytical energy + memory model for the EPIC hardware evaluation.

A copy of ``repro.core.energy`` (pure Python, no framework): the port
keeps its own so that it imports nothing of the JAX package.

Reproduces the structure of the paper's Figure 6: end-to-end system energy
and memory footprint for

  * FVS  — Full Video System (capture -> MIPI -> ISP -> H.264 on VPU -> DRAM)
  * SDS / TDS / GCS — spatial/temporal-downsample and gaze-crop systems
  * EPIC+GPU — full EPIC algorithm on a mobile GPU (no accelerator)
  * EPIC+Acc — EPIC offloaded to the dedicated accelerator
  * EPIC+Acc+In-Sensor — plus the in-sensor Frame Bypass Unit

All constants are order-of-magnitude figures for a 45nm-class mobile SoC,
drawn from the in-/near-sensor-computing literature the paper builds on
(An et al. JSSC'20; Liu et al. ISSCC'22; Sun et al. TODAES'24) and standard
technology surveys (Horowitz, ISSCC'14). The model is *relative*: its job is
to rank systems and expose where energy goes, mirroring the paper's reported
24.3x average energy and 27.5x memory reduction for EPIC+Acc+In-Sensor vs
FVS. Absolute joules depend on process/implementation details we do not
claim to reproduce.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

# ---------------------------------------------------------------------------
# Technology constants (picojoules unless noted).
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class EnergyConstants:
    # Sensing (low-power stacked digital pixel sensors: ~tens of pJ/px —
    # Liu ISSCC'22, Tsai ITE'25)
    e_capture_px: float = 25.0  # photodiode+ADC energy per pixel (pJ)
    e_insensor_cmp_px: float = 2.0  # in-sensor subtract+threshold per pixel
    # Links / preprocessing
    e_mipi_byte: float = 100.0  # MIPI D-PHY transmit per byte
    e_isp_px: float = 300.0  # ISP pipeline per pixel
    e_h264_px: float = 700.0  # H.264 encode per pixel (VPU)
    # Memory hierarchy
    e_dram_byte: float = 20.0  # LPDDR access per byte
    e_sram_byte: float = 1.0  # on-chip scratchpad access per byte
    # Compute
    e_mac_int8_acc: float = 0.3  # int8 MAC on the EPIC accelerator (45nm)
    e_mac_fp_acc: float = 1.5  # fp16/32 MAC on the accelerator
    e_mac_gpu: float = 15.0  # effective per-MAC energy on a mobile GPU
    # (instruction/register/cache overheads included)
    e_gpu_dram_byte: float = 25.0  # GPU path goes through DRAM


PJ_TO_J = 1e-12


@dataclass
class StreamCounters:
    """Per-stream activity counters produced by the pipeline / baselines.

    Fill these from `pipeline.stream_counters` stats or from a baseline's
    static schedule; `system_energy` turns them into joules.
    """

    n_frames: int = 0  # total frames of the stream
    frame_px: int = 0  # pixels per frame (H*W)
    n_processed: int = 0  # frames that crossed sensor->SoC (not bypassed)
    # EPIC algorithm work
    depth_macs: int = 0  # FastDepth MACs (int8 on Acc)
    hir_macs: int = 0  # HIR CNN MACs
    n_bbox_checks: int = 0  # bbox reprojections (16 MACs each, ~fp)
    n_full_checks: int = 0  # full patch reprojections (with the sparse
    #   TRD path, TSRCConfig.prefilter_k > 0, this is the measured
    #   candidate count, not a schedule estimate)
    patch_px: int = 0  # pixels per patch (P*P)
    # Storage outcome
    stored_bytes: int = 0  # final retained bytes (DC buffer / video)
    dc_traffic_bytes: int = 0  # DC-buffer read/write traffic
    h264: bool = False  # whether the stream is H.264-encoded (FVS)


# MACs for one bbox reprojection: 4 corners x (3 matmuls of 4x4) ~ 4*3*16.
_BBOX_MACS = 4 * 3 * 16
# MACs per pixel for full reprojection + bilinear: 3*16 (chain) + 8 (lerp).
_FULL_MACS_PX = 3 * 16 + 8


def epic_algorithm_macs(c: StreamCounters) -> Dict[str, float]:
    return {
        "depth": float(c.depth_macs),
        "hir": float(c.hir_macs),
        "bbox": float(c.n_bbox_checks * _BBOX_MACS),
        "full_reproject": float(c.n_full_checks * c.patch_px * _FULL_MACS_PX),
    }


def system_energy(
    system: str, c: StreamCounters, k: EnergyConstants = EnergyConstants()
) -> Dict[str, float]:
    """Energy breakdown (J) for one stream under a given system config.

    ``system`` in {"FVS", "SDS", "TDS", "GCS", "EPIC+GPU", "EPIC+Acc",
    "EPIC+Acc+InSensor"}.

    Baseline systems (FVS/SDS/TDS/GCS): `n_processed`/`frame_px` already
    reflect their temporal/spatial schedule (e.g. TDS processes fewer frames,
    SDS/GCS smaller frames); `stored_bytes` their retained footprint.
    """
    br: Dict[str, float] = {}
    px_total = c.n_frames * c.frame_px  # all frames hit the photodiode
    px_proc = c.n_processed * c.frame_px

    is_epic = system.startswith("EPIC")
    in_sensor = system == "EPIC+Acc+InSensor"
    on_gpu = system == "EPIC+GPU"

    # 1) Capture: every frame is exposed and digitised.
    br["sensor"] = px_total * k.e_capture_px
    # 2) In-sensor bypass comparator (EPIC+Acc+InSensor only).
    if in_sensor:
        br["in_sensor_cmp"] = px_total * k.e_insensor_cmp_px
        px_link = px_proc  # bypassed frames never leave the sensor
    elif is_epic:
        # Bypass runs on-SoC: all frames cross MIPI/ISP, then may be dropped.
        px_link = px_total
    else:
        px_link = px_proc  # baselines: schedule decides what is read out
    # 3) Link + ISP for everything that leaves the sensor.
    br["mipi"] = px_link * 3 * k.e_mipi_byte
    br["isp"] = px_link * k.e_isp_px
    # 4) Codec (FVS pipeline encodes with H.264 on the VPU).
    if c.h264:
        br["h264"] = px_proc * k.e_h264_px
    # 5) EPIC algorithm compute.
    if is_epic:
        macs = epic_algorithm_macs(c)
        if on_gpu:
            e_mac = k.e_mac_gpu
            br["alg_compute"] = sum(macs.values()) * e_mac
            # GPU keeps the DC buffer in DRAM.
            br["dc_buffer"] = c.dc_traffic_bytes * k.e_gpu_dram_byte
        else:
            # Accelerator: depth/HIR on the int8 systolic array, geometry fp.
            br["alg_compute"] = (
                (macs["depth"] + macs["hir"]) * k.e_mac_int8_acc
                + (macs["bbox"] + macs["full_reproject"]) * k.e_mac_fp_acc
            )
            br["dc_buffer"] = c.dc_traffic_bytes * k.e_sram_byte
    # 6) Final storage write (DRAM).
    br["storage"] = c.stored_bytes * k.e_dram_byte

    return {kk: v * PJ_TO_J for kk, v in br.items()}


def total_energy(system: str, c: StreamCounters,
                 k: EnergyConstants = EnergyConstants()) -> float:
    return sum(system_energy(system, c, k).values())


def memory_footprint_bytes(c: StreamCounters) -> int:
    """Retained memory footprint of the stream (what the EFM later reads)."""
    return c.stored_bytes
