"""Share of the device time launched in insert spans that sort kernels
take, %.  A sort kernel is one whose name holds one of ``PATTERNS``:
CUB's radix sort behind ``torch.sort`` on the card, and the sorts
PyTorch runs itself."""

PATTERNS = (
    "RadixSort",
    "radixSort",
    "radix_sort",
    "bitonicSort",
    "SegmentedSort",
    "segmented_sort",
    "MergeSort",
    "mergeSort",
    "sort_postprocess",
)


def is_sort(name):
    return any(p in name for p in PATTERNS)


def read(run):
    if run.op != "insert" or run.trace is None:
        return None
    total = run.trace.device_s("insert")
    if total <= 0:
        return None
    return 100 * run.trace.device_s("insert", is_sort) / total
