"""Host I/O: files, WAV, UDP / TCP transports, message bridges, XML-RPC
control and the native ring (ports of ``grtpu.io``)."""
