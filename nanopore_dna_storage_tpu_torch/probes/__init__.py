"""Hardware probes of the port: the counterparts of the TPU probe scripts
in ``scripts/``, with hand-written Hopper kernels.

* ``merge_roofline``: the suppression merge's op pattern against an
  independent elementwise stream, as element-ops per second and as a share
  of the card's FP32 lane peak (``scripts/tpu_vpu_roofline.py``); it also
  counts the ACS kernel's work per block step, so that the kernel's own
  rate can be read against the probe's (``csrc/probes.cu``).
* ``treepop``: max plus the winner's payload over the candidate axis, in
  four index orders and behind a data-dependent guard
  (``scripts/tpu_treepop_probe.py``, ``csrc/probes.cu``).
* ``expand``: the predecessor expansion ``y[j] = x[j >> log k]`` and its
  relatives as a gather, a warp shuffle or the TPU's roll butterfly, and a
  transpose (``scripts/tpu_pallas_probe2.py``, ``tpu_repeat_probe.py``,
  ``tpu_expand_probe.py``; ``csrc/expand.cu``).
* ``mxu_expand``: the same expansion as a one-hot product on the tensor
  cores, in TF32, bf16 and an exact byte-plane int8 route
  (``scripts/tpu_mxu_expand_probe.py``, ``tpu_mxu_probe2.py``,
  ``tpu_mxu_probe3.py``; ``csrc/mxu_expand.cu``).
* ``lowering``: the primitives the ACS kernel rests on (a row picked by an
  index on the card, int16 stores, the argmax loop with its state in
  registers or local memory, the candidate reshape, an in-place window
  update), and the lane repeat through ``expand``
  (``scripts/tpu_pallas_probe.py``; ``csrc/lowering.cu``).

Each kernel has a plain PyTorch version beside it; CPU tensors take it,
CUDA tensors launch the kernel.

    python -m nanopore_dna_storage_tpu_torch.probes.merge_roofline
    python -m nanopore_dna_storage_tpu_torch.probes.treepop argmax halves
    python -m nanopore_dna_storage_tpu_torch.probes.expand p3 p4
    python -m nanopore_dna_storage_tpu_torch.probes.mxu_expand
    python -m nanopore_dna_storage_tpu_torch.probes.lowering fori alias
"""
