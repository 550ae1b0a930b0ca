from ddpo_torch.native.jpeg import jpeg_sizes

__all__ = ["jpeg_sizes"]
