from dibs_tpu_torch.utils.func import (
    expand_by,
    masked_slogdet,
    pytree_sq_norm_matrix,
    squared_norm_pytree,
    standardize,
    zero_diagonal,
)

__all__ = [
    "expand_by",
    "masked_slogdet",
    "pytree_sq_norm_matrix",
    "squared_norm_pytree",
    "standardize",
    "zero_diagonal",
]
