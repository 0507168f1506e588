from paddle_tpu_torch.nn.layer.norm import RMSNorm

__all__ = ["RMSNorm"]
