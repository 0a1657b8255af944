"""Forward error correction: Reed-Solomon over GF(2^8) and the CCSDS
k=7 rate-1/2 convolutional code (port of ``grtpu.fec``)."""
