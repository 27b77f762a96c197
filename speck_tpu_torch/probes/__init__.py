"""Measurements on the card. The gather probes port the repository's gather
measurement scripts (``scripts/gather_microbench2.py`` and
``scripts/expand_microbench.py``), whose Pallas kernels become the CUDA
kernels of ``csrc/gather_probes.cu``; ``esc_profile`` splits the time of
``esc_fixed``; ``timing`` holds the timers they share (CUDA events, and
``host_ms``, the host clock of a stage ending in a synchronize).

    python -m speck_tpu_torch.probes.gather_microbench2
    python -m speck_tpu_torch.probes.expand_microbench
    python -m speck_tpu_torch.probes.esc_profile

The stage probes port the repository's stage scripts of the same names
(``scripts/<name>.py``), each at its script's size through the port's own
functions (``split`` builds their arguments as ``plan_spgemm`` does); a
split function returns rows (label, median ms, min ms, outputs) under the
script's labels, and ``main`` prints them with the card's name and power
limit:

    python -m speck_tpu_torch.probes.profile_plan [config1|giant_row|stencil27]
    python -m speck_tpu_torch.probes.mixed_probe
    python -m speck_tpu_torch.probes.rect_probe
    python -m speck_tpu_torch.probes.giant_probe
    python -m speck_tpu_torch.probes.ab_stream
    python -m speck_tpu_torch.probes.dense_probe [config4|dense_banded]
    python -m speck_tpu_torch.probes.micro2
    python -m speck_tpu_torch.probes.slice_gather_bench [M] [RW]
    python -m speck_tpu_torch.probes.ab_overlap [m] [iters] [--out DIR]

``conformance`` is the port's seeded conformance sweep: every route and
entry point on one device against the port's own CPU path and the scipy
oracle, each case named by its seed (``--seed S --cases 1`` reruns one):

    python -m speck_tpu_torch.probes.conformance [--device cuda|cpu]
        [--cases N] [--seed S] [--seconds T]

``expand_profile`` holds the expand kernel K4 to its plain version bit
for bit at the cells' chunk shape, in the three value types the cells run,
and times it beside its bound:

    python -m speck_tpu_torch.probes.expand_profile

``mesh_cards`` runs the row mesh with a shard a card in one process;
``multihost_cards`` runs ``multihost_spgemm`` across worker processes (a
card each under NCCL, or sharing one under gloo) and holds every case
against the scipy oracle and the one-process mesh:

    python -m speck_tpu_torch.probes.multihost_cards [--procs P]
        [--backend nccl|gloo] [--shards 4] [--cases ...]
        [--device cuda|cpu] [--timeout S]
"""
