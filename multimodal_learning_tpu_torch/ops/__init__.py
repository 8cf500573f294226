from .kron_fusion import kron_matmul, kron_matmul_plain
