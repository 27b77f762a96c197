"""Measurements on the card. The gather probes port the repository's gather
measurement scripts (``scripts/gather_microbench2.py`` and
``scripts/expand_microbench.py``), whose Pallas kernels become the CUDA
kernels of ``csrc/gather_probes.cu``; ``esc_profile`` splits the time of
``esc_fixed``; ``timing`` holds the CUDA-event timer they share.

    python -m speck_tpu_torch.probes.gather_microbench2
    python -m speck_tpu_torch.probes.expand_microbench
    python -m speck_tpu_torch.probes.esc_profile
"""
