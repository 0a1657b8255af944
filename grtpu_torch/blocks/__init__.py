from grtpu_torch.blocks import analog, convert, filter, gengen, pfb, stream
