from repro_torch.data.dirichlet import (dirichlet_partition,  # noqa: F401
                                        partition_stats)
from repro_torch.data.pipeline import (HomogenizedSampler,  # noqa: F401
                                       NodeSampler)
from repro_torch.data.synthetic import (make_classification_data,  # noqa: F401
                                        make_lm_data, make_public_data)
