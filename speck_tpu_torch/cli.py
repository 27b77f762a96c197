"""The port's runspECK:

    python -m speck_tpu_torch.cli matrix.mtx [config.ini] [--fp64]

Loads the matrix (B = A if square, else A^T), runs the warmup and the
measured iterations in float32 (in float64 end to end under ``--fp64``,
as ``runspeck --fp64`` does) on the first CUDA card (without one it
raises; a caller of ``main`` passes ``device="cpu"`` to run on the CPU),
and prints nnz(C), the mean complete-call time, GFLOPS and nnz(C)/s.
Config keys: InputFile, IterationsWarmUp, IterationsExecution,
TrackIndividualTimes, TrackCompleteTimes, CompareResult, and the
SpgemmConfig tuning keys.
"""

from __future__ import annotations

import sys

import torch


def main(argv=None, device=None):
    argv = list(sys.argv if argv is None else argv)
    from .executor import Executor
    from .utils.config import Config
    from .utils.device import device_info

    args = [a for a in argv[1:] if not a.startswith("--")]
    config = Config.init(args[1] if len(args) > 1 else None)
    if len(args) == 1 and args[0].endswith(".ini"):
        config = Config.init(args[0])
        args = []
    path = config.get_string("InputFile", "") or (args[0] if args else "")
    if not path:
        print("Need matrix market file path (.mtx) as first argument\n"
              "Usage: python -m speck_tpu_torch.cli <matrix.mtx> "
              "[config.ini] [--fp64]", file=sys.stderr)
        return 1
    dtype = torch.float64 if "--fp64" in argv else torch.float32
    print(f"device: {device_info(device).summary()}")
    result = Executor(path, config=config, dtype=dtype, device=device).run()
    return 0 if result.compared_ok in (None, True) else 2


if __name__ == "__main__":
    sys.exit(main())
