# repro_torch.data — deterministic synthetic LM data + host-sharded
# pipeline; NumPy copies of repro.data (the batches are the reference's,
# bit for bit: torch draws nothing here).

from repro_torch.data.synthetic import SyntheticLM, make_batch
from repro_torch.data.pipeline import DataPipeline, PipelineConfig

__all__ = ["SyntheticLM", "make_batch", "DataPipeline", "PipelineConfig"]
