"""Dataset URL resolution (counterpart of ``petastorm_tpu/fs.py:27-120``).

This slice reads and writes local stores only: ``file:///path`` URLs or
bare absolute paths. Object stores, HDFS and fsspec come in a later slice.
"""

from urllib.parse import urlparse


def normalize_dataset_url(dataset_url):
    """Accept both ``file:///path`` URLs and bare ``/path`` strings."""
    if not isinstance(dataset_url, str):
        raise ValueError('dataset_url must be a string, got {!r}'.format(type(dataset_url)))
    dataset_url = dataset_url.rstrip('/')
    if urlparse(dataset_url).scheme == '':
        if not dataset_url.startswith('/'):
            raise ValueError(
                'dataset_url {!r} has no scheme and is not an absolute path. '
                'Use e.g. file:///tmp/ds'.format(dataset_url))
        return 'file://' + dataset_url
    return dataset_url


def local_path(dataset_url):
    """``(normalized url, local filesystem path)``; raises for any scheme
    other than ``file``."""
    url = normalize_dataset_url(dataset_url)
    parsed = urlparse(url)
    if parsed.scheme != 'file':
        raise ValueError('petastorm_tpu_torch reads file:// stores only so far, '
                         'got scheme {!r} in {!r}'.format(parsed.scheme, url))
    return url, parsed.path
