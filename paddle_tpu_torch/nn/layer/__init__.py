from paddle_tpu_torch.nn.layer.norm import LayerNorm, RMSNorm

__all__ = ["LayerNorm", "RMSNorm"]
