from grtpu_torch.models.fm import (
    AmDemod, FmDeemph, FmPreemph, NbfmRx, NbfmTx, WfmRcv, WfmTx,
)
