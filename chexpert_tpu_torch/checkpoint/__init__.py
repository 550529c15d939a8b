from chexpert_tpu_torch.checkpoint.store import load_model_checkpoint, save_model_checkpoint

__all__ = ["load_model_checkpoint", "save_model_checkpoint"]
