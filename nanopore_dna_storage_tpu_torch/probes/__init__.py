"""Hardware probes of the port: the counterparts of the TPU probe scripts
in ``scripts/``, with hand-written Hopper kernels (``csrc/probes.cu``).

* ``merge_roofline``: the suppression merge's op pattern against an
  independent elementwise stream, as element-ops per second and as a share
  of the card's FP32 lane peak (``scripts/tpu_vpu_roofline.py``); it also
  counts the ACS kernel's work per block step, so that the kernel's own
  rate can be read against the probe's.
* ``treepop``: max plus the winner's payload over the candidate axis, in
  four index orders and behind a data-dependent guard
  (``scripts/tpu_treepop_probe.py``).

Each kernel has a plain PyTorch version beside it; CPU tensors take it,
CUDA tensors launch the kernel.

    python -m nanopore_dna_storage_tpu_torch.probes.merge_roofline
    python -m nanopore_dna_storage_tpu_torch.probes.treepop argmax halves
"""
