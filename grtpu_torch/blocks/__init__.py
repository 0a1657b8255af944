from grtpu_torch.blocks import analog, filter, gengen
