from repro_torch.core.mip.model import LinExpr, MipModel, Status, Var
