from dibs_tpu_torch.utils.func import expand_by, zero_diagonal

__all__ = ["expand_by", "zero_diagonal"]
