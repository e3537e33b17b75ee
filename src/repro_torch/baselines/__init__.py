"""The baseline graph-similarity methods the paper compares against
(Table 3): the port's copy of `repro.baselines`."""
from repro_torch.baselines.deltacon import (deltacon_distance,
                                            deltacon_similarity,
                                            rmd_distance)
from repro_torch.baselines.degree_dist import (bhattacharyya_distance,
                                               cosine_distance,
                                               hellinger_distance)
from repro_torch.baselines.ged import graph_edit_distance
from repro_torch.baselines.lambda_dist import lambda_distance
from repro_torch.baselines.veo import veo_score
from repro_torch.baselines.vnge_variants import vnge_gl, vnge_nl
