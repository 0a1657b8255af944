"""Digital modulation: constellations, synchronization loops, modems and
their graph blocks (port of ``grtpu.digital``)."""
