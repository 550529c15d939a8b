from chexpert_tpu_torch.configs.config import Config, resolve_output_dir, setup_output_dir

__all__ = ["Config", "resolve_output_dir", "setup_output_dir"]
