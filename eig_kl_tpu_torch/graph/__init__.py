from eig_kl_tpu_torch.graph.expand import clique_expand
from eig_kl_tpu_torch.graph.csr import Graph, DeviceGraph, device_graph_from_jax

__all__ = ["clique_expand", "Graph", "DeviceGraph", "device_graph_from_jax"]
