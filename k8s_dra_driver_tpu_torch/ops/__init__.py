"""Attention operators: the dense oracle and the two Hopper kernels
(flash-attention forward, paged decode) with their plain versions."""
