"""The graph-classification head-to-head of the port against the JAX
package (``head_to_head_graph_port``)."""
