from grtpu_torch.runtime.block import Block, Port, StreamSpec, port_b, port_c, port_f, port_i, port_s
from grtpu_torch.runtime.graph import Endpoint, FlatGraph, Graph, HierBlock
from grtpu_torch.runtime.executor import StreamExecutor
from grtpu_torch.runtime.tags import Tag, propagate_tags, tags_in_window
