from deep_vision_tpu_torch.nn.layers import BatchNorm, ConvBN, same_padding

__all__ = ["BatchNorm", "ConvBN", "same_padding"]
