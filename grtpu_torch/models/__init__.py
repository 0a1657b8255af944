from grtpu_torch.models.fm import FmDeemph, WfmRcv
