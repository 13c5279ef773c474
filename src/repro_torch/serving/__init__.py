from repro_torch.serving.engine import (GenerationEngine, GenResult,
                                        SlotDecoder, valid_token_count)
from repro_torch.serving.pipeline import (PartitionedCNNRunner,
                                          PartitionedLMRunner, StageReport,
                                          def4_throughput,
                                          link_transfer_bytes,
                                          pipeline_report)
