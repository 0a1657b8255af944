from grtpu_torch.blocks import analog, convert, fftblk, filter, gengen, misc, oscope, pfb, stream
