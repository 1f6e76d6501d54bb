"""Accelerator type constants.

Reference: ``python/ray/util/accelerators/accelerators.py:1-8`` — NVIDIA
only, no TPU (SURVEY.md §2.3 calls this out).  The TPU build makes TPU
generations first-class scheduling labels, and the PyTorch port runs on
an NVIDIA H100 (``NVIDIA_H100``): request with
``@remote(accelerator_type=TPU_V5P)`` -> the scheduler matches nodes whose
``accelerator_type`` label agrees (node labels set at add_node time)."""

TPU_V4 = "TPU-V4"
TPU_V5E = "TPU-V5E"
TPU_V5P = "TPU-V5P"
TPU_V6E = "TPU-V6E"

# Kept for reference-code compatibility: CUDA types map onto scheduling
# labels too, so code written against the reference imports cleanly.
NVIDIA_TESLA_V100 = "V100"
NVIDIA_TESLA_T4 = "T4"
NVIDIA_TESLA_A100 = "A100"
NVIDIA_H100 = "H100"

ALL_TPU = (TPU_V4, TPU_V5E, TPU_V5P, TPU_V6E)
