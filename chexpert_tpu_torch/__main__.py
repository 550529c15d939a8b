"""`python -m chexpert_tpu_torch`: the port's entry points."""

USAGE = """chexpert_tpu_torch: the PyTorch / CUDA port of chexpert_tpu (NVIDIA H100)

Entry points (each runs on --device cuda unless --device cpu is given):
  python -m chexpert_tpu_torch.cli.chexpert    train / evaluate / ensemble /
                                               visualize / plot_roc
  python -m chexpert_tpu_torch.cli.predict     competition inference to CSV
  python -m chexpert_tpu_torch.cli.bench       CIFAR model test-bench
  python -m chexpert_tpu_torch.cli.serve       HTTP inference server
  python -m chexpert_tpu_torch.cli.data_tools  dataset inspect / stats / explore
  python3 chip_smoke.py                        smoke run of every path on one card

See README.md.
"""

if __name__ == "__main__":
    print(USAGE)
