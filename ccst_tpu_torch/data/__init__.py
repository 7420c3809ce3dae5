from ccst_tpu_torch.data.lists import (
    parse_list,
    write_list,
    stylized_output_path,
    generate_k_lists,
    train_list_path,
    test_list_path,
)
from ccst_tpu_torch.data.loader import ImageBatchLoader, load_image
