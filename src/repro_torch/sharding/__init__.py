from repro_torch.sharding.rules import (ShardingPlan, distribute_params,
                                        m_REPLICATE, m_SPLIT_K, m_SPLIT_N,
                                        make_plan, mesh_grad_choices,
                                        mesh_tp_choices, placements)
