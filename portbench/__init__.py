"""The benchmark of tpu_mot_torch on one or four CUDA cards (BENCHMARK.json
at the repo root; `python3 portbench/run.py --help`)."""
