"""HERO's own PMCA configuration space (paper Tab.1) as a config graph.

The paper's configurability table is reproduced verbatim as axes; the
flattened cells drive the Tab.2-analogue resource sweep.  Bold/underlined
values in the paper (Juno ADP / ZC706 implementations) are exposed as the
two named presets.  Copied from ``repro.configs.hero_pmca``.
"""
from repro_torch.core.buildflow import ConfigGraph


def pmca_config_space() -> ConfigGraph:
    g = (ConfigGraph()
         .axis("clusters", [1, 2, 4, 8])
         .axis("interconnect", ["bus", "noc"])
         .axis("pes_per_cluster", [2, 4, 8])
         .axis("fpu", ["private", "shared", "off"])
         .axis("l1_spm_kib", [32, 64, 128, 256])
         .axis("l2_spm_kib", [32, 64, 128, 256])
         .axis("icache_kib", [2, 4, 8])
         .axis("rab_l1_tlb", [4, 8, 16, 32, 64])
         .axis("rab_l2_tlb", [0, 256, 512, 1024, 2048])
         .axis("rab_l2_assoc", [16, 32, 64])
         .axis("rab_l2_banks", [1, 2, 4, 8])
         .constraint(lambda c: c["rab_l2_tlb"] == 0 or
                     c["rab_l2_tlb"] % (c["rab_l2_assoc"] * c["rab_l2_banks"])
                     == 0 or c["rab_l2_tlb"] % c["rab_l2_assoc"] == 0))
    return g


JUNO_ADP = {  # bold values in Tab.1 (8 clusters, Juno)
    "clusters": 8, "interconnect": "bus", "pes_per_cluster": 8,
    "fpu": "off", "l1_spm_kib": 256, "l2_spm_kib": 256, "icache_kib": 4,
    "rab_l1_tlb": 32, "rab_l2_tlb": 1024, "rab_l2_assoc": 32,
    "rab_l2_banks": 4, "clock_mhz": 31.0,
}

ZC706 = {  # underlined values (1 cluster, ZC706)
    "clusters": 1, "interconnect": "bus", "pes_per_cluster": 8,
    "fpu": "off", "l1_spm_kib": 256, "l2_spm_kib": 256, "icache_kib": 4,
    "rab_l1_tlb": 32, "rab_l2_tlb": 1024, "rab_l2_assoc": 16,
    "rab_l2_banks": 4, "clock_mhz": 57.0,
}
