from repro_torch.core.hwmodel.arch import (AcceleratorArch, EYERISS_LIKE,
                                           SIMBA_LIKE, TPU_V5E, get_arch)
from repro_torch.core.hwmodel.energy import EnergyTable
from repro_torch.core.hwmodel.mapper import (LayerCost, evaluate_layer,
                                             evaluate_segment)
