from polars_tpu_torch.expr.expr import Expr

__all__ = ["Expr"]
