from repro_torch.sharding.rules import (m_REPLICATE, m_SPLIT_K, m_SPLIT_N,
                                        mesh_grad_choices, mesh_tp_choices)
