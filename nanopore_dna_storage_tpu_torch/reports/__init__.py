"""The paper-scale reports, run on the port.

Each module runs as ``python -m nanopore_dna_storage_tpu_torch.reports.<name>``
and keeps the flags and the JSON keys of the repository's report script of
the same purpose, with ``--device`` (``cuda`` by default; ``cpu`` on
request) in place of ``--backend`` and ``--cpu``:

- ``file_recovery`` (``scripts/file_recovery_report.py``): the published
  11,280-byte file encoded at one experiment, recovered from simulated
  channel reads through the decode, the CRC/index check, the vote and
  Reed-Solomon; resumable from a state file.
- ``read_cost`` (``scripts/read_cost_report.py``): the same decode of a
  read corpus, then supplementary Table 2's sweep of read counts with
  random trials, and the reading cost in bases per bit.
- ``basecall_error`` (``scripts/basecall_error_probe.py``): a basecaller
  trained from scratch on the hermetic pore model, its basecall error by
  edit distance on held-out reads.
- ``signal_fidelity`` (``scripts/signal_fidelity_report.py``): that
  basecaller's reads decoded at a published experiment, with the Table-3
  breakdown.

``corpus`` holds the decode-and-classify loop that the first two share.
Each module exposes ``run``, which takes the experiment, the file size or
the data, and the run's numbers; its ``main`` parses the flags into that
call.
"""
